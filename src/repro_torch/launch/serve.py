"""Batched serving CLI over the port's continuous-batching Engine.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      --mult trunc2x2 --kernel-policy pallas --batch 4 --prompt-len 64 \
      --gen 32

Submits a batch of synthetic prompts as requests, serves them through the
engine's prefill-then-join decode loop on the CUDA device, and reports
per-phase latency and tokens/s.  `--arch` takes any config of a ported
family: the dense `lm` ones (starcoder2-7b's GELU MLP among them),
`llama-3.2-vision-11b`, `whisper-medium`, `mamba2-370m` and
`recurrentgemma-9b` (mamba2's prompt length must be at most its SSD
chunk, 256, or a multiple of it).  Whisper's requests carry synthetic
frames and the vision model's synthetic image embeddings
(`data/synthetic.frames_batch` / `img_batch`), one per request.
`--device cpu` runs the plain PyTorch versions instead (use `--reduced`
there).

`--mesh model=2` (or $REPRO_MESH) serves tensor-parallel, one process per
rank, under torchrun; `--mesh data=2` gives each data rank its block of
the slots (where the data axis divides the capacity), and
`model=2,data=2` both; only rank 0 prints:

  torchrun --nproc-per-node 2 -m repro_torch.launch.serve --mesh data=2 \
      --arch tinyllama-1.1b --mult trunc2x2 --kernel-policy pallas
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch import configs
from repro_torch.data import synthetic
from repro_torch.serving import Engine, Request, SamplingParams


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--mult", default="")
    ap.add_argument("--kernel-policy", default="",
                    choices=["", "auto", "pallas", "xla"],
                    help="GEMM/attention dispatch (kernels/dispatch.py): "
                         "'pallas' = the CUDA kernels, 'xla' = the plain "
                         "PyTorch versions")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--capacity", type=int, default=0,
                    help="decode-arena slots (default: --batch)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="top-k filter (0 = off)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    ap.add_argument("--mesh", default="",
                    help="mesh spec, e.g. 'model=2,data=2' (default: "
                         "$REPRO_MESH, then the host mesh over torchrun's "
                         "ranks); a model axis > 1 serves tensor-parallel")
    args = ap.parse_args(argv)

    from repro_torch.launch import mesh as meshmod
    meshmod.init_from_env(args.device)
    mesh = meshmod.make_mesh_from_spec(args.mesh)

    cfg = configs.apply_overrides(configs.get_config(args.arch),
                                  reduced=args.reduced, mult=args.mult,
                                  kernel_policy=args.kernel_policy)
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab, (args.batch, args.prompt_len))
    frames = img = None
    if cfg.family == "encdec":
        frames = synthetic.frames_batch(args.batch, cfg.enc_seq,
                                        cfg.d_model, 0, args.seed)
    if cfg.cross_every:
        img = synthetic.img_batch(args.batch, cfg.n_img_tokens,
                                  cfg.d_model, 0, args.seed)
    max_len = args.prompt_len + args.gen
    eng = Engine(cfg, capacity=args.capacity or args.batch, max_len=max_len,
                 prefill_buckets=(args.prompt_len,), seed=args.seed,
                 device=args.device, mesh=mesh)
    sp = SamplingParams(temperature=args.temperature, top_k=args.top_k,
                        max_new_tokens=args.gen)
    for i in range(args.batch):
        extras = {}
        if frames is not None:
            extras["frames"] = frames[i]
        if img is not None:
            extras["img_embeds"] = img[i]
        eng.submit(Request(f"r{i}", prompts[i].tolist(), sp,
                           extras=extras or None))
    done = eng.run_until_complete()

    stats = eng.stats()
    decode_toks = sum(len(c.tokens) - 1 for c in done)
    toks_per_s = decode_toks / max(stats["decode_s"], 1e-9)
    first = next(c for c in done if c.request_id == "r0")
    if mesh.rank != 0:
        return 0
    print(f"[serve] arch={cfg.name} mult={cfg.mult or 'exact'} "
          f"batch={args.batch} device={stats['device']} "
          f"mesh={stats['mesh']}")
    if "tp" in stats:
        tp, data = stats["tp"], stats["tp"]["data"]
        print(f"[serve] all-gathers per decode step: model axis "
              f"{tp['all_gathers_per_decode_step']:.1f} "
              f"({tp['collective_s']:.3f}s), data axes "
              f"{data['all_gathers_per_decode_step']:.1f} "
              f"({data['collective_s']:.3f}s); "
              f"{tp['rows_per_rank']} of {eng.capacity} slots per rank")
    print(f"[serve] prefill {args.prompt_len} toks: "
          f"{stats['prefill_s']:.3f}s; decode: {toks_per_s:.1f} tok/s")
    print(f"[serve] sample continuation ids: "
          f"{np.asarray(first.tokens[:16])}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
