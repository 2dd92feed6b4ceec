"""End-to-end training entry point of the port, on one device or a mesh.

  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
      --reduced --steps 200 --batch 8 --seq 128 --ckpt-dir /tmp/run1

`--mesh data=2` (or $REPRO_MESH, then the host mesh over torchrun's
ranks) trains on a mesh, one process per rank (`train_step.
make_train_step`: data-parallel over "data", the model axis
column-parallel, FSDP where the options or the config ask for it); a
checkpoint written on one mesh restores onto any other, or onto one
device; only rank 0 prints and writes:

  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
      --mesh data=2 --reduced --steps 20 --device cpu

Synthetic deterministic data (`data.synthetic.batch_for`, a pure function
of (seed, step)), async checkpoints every `--ckpt-every` steps with
auto-resume from the newest intact one (crash and preemption safe), a
straggler watchdog, the approximate multiplier (`--mult`) and the kernel
dispatch policy (`--kernel-policy`).  Runs on the CUDA device unless
`--device cpu` is given (then use `--reduced`).  `train(cfg, options,
...)` is the loop itself, for callers that build their own config.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch import configs
from repro_torch.configs.base import ModelConfig
from repro_torch.data import synthetic
from repro_torch.device import resolve_device
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import fault
from repro_torch.train import train_step as ts


def train(cfg: ModelConfig, options: ts.StepOptions, *, steps: int,
          batch: int = 8, seq: int = 128, seed: int = 0,
          ckpt_dir: str = "", ckpt_every: int = 50, log_every: int = 10,
          device=None, guard: fault.PreemptionGuard | None = None,
          mesh=None) -> dict:
    """Train `cfg` from step 0, or from the newest checkpoint in
    `ckpt_dir`, to `steps`, on `device` or, on every rank of a `mesh` of
    more than one, through `make_train_step` on the mesh's device (the
    state is then the rank's blocks).  Returns {"state", "start_step", "losses", "gnorms",
    "step_s"} (one entry per step run; step_s on the host clock after the
    step's loss is read back)."""
    sharded = mesh is not None and mesh.size > 1
    dev = mesh.device if sharded else resolve_device(device)
    st_sh = None
    if sharded:
        init_fn, step_fn, st_sh = ts.make_train_step(cfg, options, mesh)
    else:
        init_fn, step_fn = ts.make_train_fns(cfg, options, dev)
    lead = not sharded or mesh.rank == 0

    def say(msg: str) -> None:
        if lead:
            print(msg, flush=True)

    where = {"shardings": st_sh, "mesh": mesh if sharded else None}
    watchdog = fault.StragglerWatchdog(
        on_straggler=lambda s, d, m: say(
            f"[fault] straggler at step {s}: {d:.3f}s vs median {m:.3f}s"))
    mgr = ckpt.CheckpointManager(ckpt_dir) if ckpt_dir else None
    start_step = 0
    state = init_fn(seed)
    if mgr is not None and mgr.latest_step() is not None:
        state, start_step = mgr.restore(state, **where)
        say(f"[train] resumed from step {start_step}")
    losses, gnorms, step_s = [], [], []
    t_start = time.perf_counter()
    for step in range(start_step, steps):
        watchdog.step_start()
        t0 = time.perf_counter()
        b = ts.batch_to(synthetic.batch_for(cfg, "train", batch, seq, step,
                                            seed), dev)
        state, metrics = step_fn(state, b)
        loss = float(metrics["loss"])
        step_s.append(time.perf_counter() - t0)
        losses.append(loss)
        gnorms.append(float(metrics["gnorm"]))
        watchdog.step_end(step)
        if step % log_every == 0 or step == steps - 1:
            dt = time.perf_counter() - t_start
            say(f"[train] step {step:5d} loss {loss:8.4f} "
                f"gnorm {gnorms[-1]:8.3f} "
                f"({dt / max(step - start_step + 1, 1):.2f}s/step)")
        if mgr is not None and (step + 1) % ckpt_every == 0:
            mgr.save(state, step + 1, blocking=False, **where)
        preempted = guard is not None and guard.preempted
        if sharded:   # every rank stops at the same step
            preempted = mesh.all_reduce_max([preempted])[0] > 0
        if preempted:
            say("[train] preemption requested: checkpointing + exit")
            if mgr is not None:
                mgr.save(state, step + 1, blocking=True, **where)
            break
    else:
        if mgr is not None:
            mgr.save(state, steps, blocking=True, **where)
    if mgr is not None:
        mgr.wait()
    if losses:
        first = np.mean(losses[:5]) if len(losses) >= 5 else losses[0]
        say(f"[train] done: loss {first:.4f} -> "
            f"{np.mean(losses[-5:]):.4f} "
            f"({len(watchdog.flagged)} straggler steps flagged)")
    return {"state": state, "start_step": start_step, "losses": losses,
            "gnorms": gnorms, "step_s": step_s}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CPU-scale)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--mult", default="",
                    help="approximate multiplier (paper mode)")
    ap.add_argument("--kernel-policy", default="",
                    choices=["", "auto", "pallas", "xla"],
                    help="GEMM/attention dispatch (kernels/dispatch.py): "
                         "'pallas' = the CUDA kernels, 'xla' = the plain "
                         "PyTorch versions")
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "adafactor"])
    ap.add_argument("--moment-dtype", default="f32",
                    choices=["f32", "bf16", "int8"])
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--d-model", type=int, default=0,
                    help="override width (e.g. ~100M quickstart)")
    ap.add_argument("--n-layers", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    ap.add_argument("--mesh", default="",
                    help="mesh spec, e.g. 'data=2' or 'model=2,data=2' "
                         "(default: $REPRO_MESH, then the host mesh over "
                         "torchrun's ranks); one rank trains on one device")
    args = ap.parse_args(argv)

    over = {}
    if args.d_model:
        over["d_model"] = args.d_model
        over["n_heads"] = max(4, args.d_model // 64)
        over["n_kv_heads"] = max(2, args.d_model // 128)
        over["d_ff"] = args.d_model * 3
        over["head_dim"] = 64
    if args.n_layers:
        over["n_layers"] = args.n_layers
    cfg = configs.apply_overrides(configs.get_config(args.arch),
                                  reduced=args.reduced, mult=args.mult,
                                  kernel_policy=args.kernel_policy, **over)
    options = ts.StepOptions(
        accum_steps=args.accum, optimizer=args.optimizer,
        moment_dtype=args.moment_dtype, lr=args.lr,
        total_steps=args.steps, warmup_steps=max(10, args.steps // 20))
    from repro_torch.launch import mesh as meshmod
    meshmod.init_from_env(args.device)
    mesh = meshmod.make_mesh_from_spec(args.mesh)
    dev = mesh.device or resolve_device(args.device)
    with fault.PreemptionGuard() as guard:
        train(cfg, options, steps=args.steps, batch=args.batch,
              seq=args.seq, seed=args.seed, ckpt_dir=args.ckpt_dir,
              ckpt_every=args.ckpt_every, log_every=args.log_every,
              device=dev, guard=guard, mesh=mesh)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
