"""Rank programs of tests/test_torch_train_sharded.py: top-level functions
that `repro_torch.launch.mesh.spawn` runs on every rank of a world (they
import torch and repro_torch only), and the one-device runs the tests
hold them to.

The setup is the JAX package's own sharded-step test
(tests/test_distributed.py): reduced TinyLlama with remat, a global
batch of 8 x 64 from `synthetic.lm_batch`, two micro-batches, lr 1e-3.
Every program returns host data: per step the loss and gradient norm,
and every param leaf gathered whole."""

from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np
import torch

from repro_torch import configs
from repro_torch.approx import gemm as G
from repro_torch.approx import layers as AL
from repro_torch.data import synthetic
from repro_torch.launch import train as launch
from repro_torch.sharding import ctx, rules
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts

CPU = torch.device("cpu")
BATCH, SEQ, STEPS = 8, 64, 2
LR = 1e-3


def config(mult: str):
    return configs.reduced(configs.get_config("tinyllama-1.1b"), remat=True,
                           mult=mult, kernel_policy="xla")


def options(**kw) -> ts.StepOptions:
    return ts.StepOptions(accum_steps=2, lr=LR, total_steps=50, **kw)


def batches(cfg) -> list[dict]:
    return [ts.batch_to(synthetic.lm_batch(cfg.vocab, BATCH, SEQ, step=i),
                        CPU) for i in range(STEPS)]


def whole_params(mesh, state: dict, st_sh: dict) -> dict:
    return opt.state_map(mesh.gather_leaf, state["params"],
                         st_sh["params"])


def _record(metrics: dict) -> dict:
    return {"loss": metrics["loss"].item(), "gnorm": metrics["gnorm"].item()}


def one_device_run(mult: str, **kw) -> dict:
    """`make_train_fns` on the CPU: the oracle of every world."""
    cfg = config(mult)
    init, step = ts.make_train_fns(cfg, options(**kw), CPU)
    state, out = init(0), []
    for b in batches(cfg):
        state, m = step(state, b)
        out.append(_record(m))
    return {"metrics": out, "params": state["params"],
            "opt": dict(_host_leaves(state["opt"]))}


def _host_leaves(state) -> list:
    """(checkpoint name, numpy array) of every leaf; bf16 as its bits."""
    return [(name, ckpt._to_numpy(t))
            for name, t in ckpt._named_leaves(state)]


def step_world(mesh, mult: str, kw: dict) -> dict:
    """`make_train_step` on this rank: STEPS steps on the global batches;
    the whole params and optimizer state after the last, and the rank's
    block shapes."""
    cfg = config(mult)
    init, step, st_sh = ts.make_train_step(cfg, options(**kw), mesh)
    state, out = init(0), []
    shapes = {name: tuple(t.shape)
              for name, t in ckpt._named_leaves(state)}
    for b in batches(cfg):
        state, m = step(state, b)
        out.append(_record(m))
    return {"metrics": out, "params": whole_params(mesh, state, st_sh),
            "opt": dict(_host_leaves(opt.state_map(
                mesh.gather_leaf, state["opt"], st_sh["opt"]))),
            "shapes": shapes, "calls": dict(mesh.calls)}


def sharded_world(mesh, cases: list, where: str, ref) -> dict:
    """A world of the tests: `step_world` for each (mult, kw) of `cases`;
    at model=2 alone the column-parallel gradients, at model=2,data=2 a
    save, at data=2 the elastic restore, the CLI, the MoE refusal and
    the reference anchor (`ref`: the JAX package's state and batch)."""
    out = {"steps": {i: step_world(mesh, mult, kw)
                     for i, (mult, kw) in enumerate(cases)}}
    data, model = mesh.axis_size("data"), mesh.axis_size("model")
    elastic = os.path.join(where, "elastic")
    if model > 1 and data == 1:
        out["grads"] = grad_ops(mesh)
        out["serve"] = serve_steps(mesh)
    if model > 1 and data > 1:
        out["save"] = save_world(mesh, elastic)
    if model == 1 and data > 1:
        out["restore"] = restore_world(mesh, elastic)
        out["cli"] = cli_world(mesh, os.path.join(where, "cli"))
        out["moe"] = moe_world(mesh)
        out["reference"] = reference_world(mesh, *ref)
    return out


def reference_world(mesh, state_np, bnp) -> dict:
    """One step from the reference's state (as numpy), on the reference's
    test configuration under trunc2x2."""
    cfg = config("trunc2x2")
    init, step, st_sh = ts.make_train_step(cfg, options(), mesh)
    whole = ts.state_from_reference(state_np, cfg, CPU)
    state = opt.state_map(mesh.block, whole, st_sh)
    _, m = step(state, ts.batch_to(bnp, CPU))
    return _record(m)


# --- gradients through the column-parallel ops ------------------------------

def grad_ops(mesh=None) -> dict:
    """Gradients of a scalar through `gather_cols` of a block, the exact
    column-parallel GEMM (gather=False and True), the approximate one
    (gather=False) and a split bias (`dense(gather=False)`), under the
    mesh's rules, or on one device with `mesh` None."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 5, 16)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((16, 12)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((12,)).astype(np.float32))
    r = torch.from_numpy(rng.standard_normal((2, 5, 12)).astype(np.float32))
    spec = G.spec_from_name("trunc2x2").with_policy("xla")
    out = {}
    for name, mult, bias, gather in (("exact_block", None, False, False),
                                     ("exact_whole", None, False, True),
                                     ("approx_block", spec, False, False),
                                     ("bias_block", None, True, False),
                                     ("approx_bias_block", spec, True,
                                      False)):
        xs, ws, bs = (t.clone().requires_grad_() for t in (x, w, b))
        with (ctx.use_rules(mesh, rules.logical_rules(mesh)) if mesh
              else _nothing()):
            y = AL.dense(xs, ws, bs if bias else None, mult, gather=gather)
            if not gather:
                y = AL.gather_cols(torch.tanh(y), AL.column_split(ws))
            else:
                y = torch.tanh(y)
            loss = (y * r).sum()
        gx, gw, gb = torch.autograd.grad(
            loss, (xs, ws, bs), allow_unused=True)
        out[name] = {"loss": loss.detach(), "x": gx, "w": gw,
                     "b": None if gb is None else gb}
    return out


def serve_steps(mesh=None) -> dict:
    """Prefill of two prompts and two greedy decode steps through
    `make_prefill_step` / `make_decode_step` on `mesh`, or through
    `api.prefill` / `api.decode_step` on one device: the logits of each."""
    from repro_torch.models import api
    cfg = config("trunc2x2")
    params = api.init_params(cfg, 0, CPU)
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, (2, 12)))
    if mesh is None:
        spec = api.make_spec(cfg, device=CPU)
        lg, cache = api.prefill(params, tokens, cfg, spec, max_len=16)
        decode = functools.partial(api.decode_step, cfg=cfg, spec=spec)
    else:
        lg, cache = ts.make_prefill_step(cfg, mesh, max_len=16)(params,
                                                                 tokens)
        decode = ts.make_decode_step(cfg, mesh)
    out = [lg]
    for _ in range(2):
        tok = torch.argmax(out[-1], dim=-1)[:, None]
        lg, cache = decode(params, cache, tok)
        out.append(lg[:, -1])
    return {"logits": out}


class _nothing:
    def __enter__(self):
        return None

    def __exit__(self, *a):
        return False


# --- elastic restore ---------------------------------------------------------

def save_world(mesh, where: str) -> dict:
    """One step at this mesh, then a save (rank 0 writes); the whole
    state as saved."""
    cfg = config("trunc2x2")
    init, step, st_sh = ts.make_train_step(cfg, options(), mesh)
    state, _ = step(init(0), batches(cfg)[0])
    ckpt.CheckpointManager(where).save(state, 1, shardings=st_sh,
                                       mesh=mesh)
    return {"saved": dict(ckpt._named_leaves(opt.state_map(
        mesh.gather_leaf, state, st_sh)))}


def restore_world(mesh, where: str) -> dict:
    """Restore onto this mesh; the whole restored leaves and the next
    step's metrics."""
    cfg = config("trunc2x2")
    init, step, st_sh = ts.make_train_step(cfg, options(), mesh)
    restored, at = ckpt.CheckpointManager(where).restore(
        init(0), shardings=st_sh, mesh=mesh)
    whole = dict(ckpt._named_leaves(opt.state_map(mesh.gather_leaf,
                                                  restored, st_sh)))
    _, m = step(restored, batches(cfg)[1])
    return {"at": at, "whole": whole, "next": _record(m)}


def cli_world(mesh, where: str) -> dict:
    """The train CLI on this world: 2 steps with checkpoints."""
    os.environ.pop("REPRO_MESH", None)
    rc = launch.main(["--reduced", "--mult", "trunc2x2", "--kernel-policy",
                      "xla", "--steps", "2", "--batch", "4", "--seq", "32",
                      "--ckpt-dir", where, "--ckpt-every", "1",
                      "--log-every", "1", "--device", "cpu",
                      "--mesh", ",".join(f"{k}={v}" for k, v in
                                         mesh.shape.items() if v > 1)])
    return {"rc": rc}


def reduced_moe():
    return dataclasses.replace(configs.reduced(configs.get_config(
        "grok-1-314b")), kernel_policy="xla")


def moe_world(mesh) -> str:
    try:
        ts.make_train_step(reduced_moe(), options(), mesh)
    except NotImplementedError as e:
        return str(e)
    return "trained"


# --- the compressed all-reduce and the pipeline (test_torch_compress_pipeline)

def compress_pipeline_world(mesh, xs, g, ef_steps: int, w, x_mb) -> dict:
    """At data=4: `compressed_allreduce` of rank r's row of `xs`, the
    mean through `make_compressed_allreduce_fn` of row 0 (replicated),
    and `ef_steps` steps of
    `ef_compressed_allreduce` on row r of `g`; then, on a stage=4 mesh
    of the same ranks, `pipeline_apply` of tanh(x @ w_i) over `x_mb` and
    the sequential composition on this rank."""
    from repro_torch.launch import mesh as meshmod
    from repro_torch.sharding import compress, pipeline

    r = mesh.axis_index("data")
    x = torch.from_numpy(xs[r])
    out = {"sum": compress.compressed_allreduce(x, mesh, "data"),
           "mean": compress.make_compressed_allreduce_fn(mesh, "data")(
               torch.from_numpy(xs[0]))}
    gr = torch.from_numpy(g[r])
    e = torch.zeros_like(gr)
    outs, errs = [], []
    for _ in range(ef_steps):
        o, e = compress.ef_compressed_allreduce(gr, e, mesh, "data")
        outs.append(o)
        errs.append(e)
    out["ef_out"], out["ef_err"] = torch.stack(outs), torch.stack(errs)
    out["wire"] = dict(mesh.bytes)
    stage = meshmod.mesh_from_axes((("stage", mesh.size),))
    wt, xt = torch.from_numpy(w), torch.from_numpy(x_mb)

    def stage_fn(wi, h):
        return torch.tanh(h @ wi)

    out["pipeline"] = pipeline.pipeline_apply(stage_fn, wt, xt, stage)
    seq = xt
    for i in range(wt.shape[0]):
        seq = stage_fn(wt[i], seq)
    out["sequential"] = seq
    try:
        pipeline.pipeline_apply(stage_fn, wt.requires_grad_(), xt, stage)
        out["grad"] = "ran"
    except NotImplementedError as err:
        out["grad"] = str(err)
    return out
