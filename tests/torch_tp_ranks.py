"""Rank programs of tests/test_torch_tp.py: top-level functions that
`repro_torch.launch.mesh.spawn` runs on every rank of a world (they
import torch and repro_torch only, so the ranks start without JAX), and
the one-device runs the tests hold them to.

Every program runs on the CPU at the reduced size, under gloo, and
returns host data (completions without their host times, non-timing
stats, logits as arrays)."""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.approx import gemm as G
from repro_torch.approx import layers as AL
from repro_torch.core import accelerator as acc
from repro_torch.core import calibrate as cal
from repro_torch.core import target as tg
from repro_torch.kernels import ops
from repro_torch.models import api
from repro_torch.serving import Engine, PagedEngine, Request, SamplingParams
from repro_torch.sharding import ctx, rules

CPU = torch.device("cpu")
GEMM_MULTS = ("trunc2x2", "exact", "pareto:0.02:r2")
#: stats() entries read off a host clock: every rank has its own
TIMING = {"prefill_s", "decode_s", "collective_s", "decode_collective_s",
          "chunk_step_s"}
#: (arch, mult) of the slot-engine checks
ENGINE_CASES = (("tinyllama-1.1b", "exact"), ("tinyllama-1.1b", "trunc2x2"),
                ("mamba2-370m", "trunc2x2"))


def gemm_shapes() -> list[tuple[int, int, int]]:
    """The reference's (96, 160, 256) and an N the model axis does not
    divide (the replicated branch)."""
    return [(96, 160, 256), (96, 160, 255), (4, 160, 256)]


def operands(m: int, k: int, n: int):
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.integers(-128, 128, (m, k)).astype(np.int8))
    b = torch.from_numpy(rng.integers(-128, 128, (k, n)).astype(np.int8))
    return a, b


def _rules(mesh):
    return ctx.use_rules(mesh, rules.logical_rules(mesh))


def gemm_world(mesh) -> dict:
    """The TP GEMM at the kernel level (`ops.approx_qgemm_tp` /
    `approx_qgemm_replicated`) and through the model's layer
    (`AL.gemm`: raw, prepared whole, prepared as the rank's block; exact
    float too), each held bit for bit to the one-device GEMM here; the
    kernel-level outputs come back for the JAX comparison."""
    tp = mesh.axis_size("model")
    out = {}
    for mult in GEMM_MULTS:
        for policy in ("pallas", "xla"):
            spec = G.spec_from_name(mult).with_policy(policy)
            for m, k, n in gemm_shapes():
                a, b = operands(m, k, n)
                one = ops.approx_qgemm(a, b, spec) if policy == "pallas" \
                    else G.approx_qgemm(a, b, spec)
                if n % tp == 0:
                    got = ops.approx_qgemm_tp(a, mesh.shard_cols(b), spec,
                                              mesh)
                    block = ops.approx_qgemm_tp(a, mesh.shard_cols(b), spec,
                                                mesh, gather=False)
                    assert torch.equal(block, mesh.shard_cols(one))
                else:
                    got = ops.approx_qgemm_replicated(a, b, spec)
                assert torch.equal(got, one), (mult, policy, m, k, n)
                out[(mult, policy, m, k, n)] = got
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((5, 48), generator=gen)
    w = torch.randn((48, 64), generator=gen) * 0.2
    for mult in GEMM_MULTS:
        spec = None if mult == "exact" else \
            G.spec_from_name(mult).with_policy("pallas")
        forms = {"raw": w}
        if spec is not None:
            whole = G.prepare_weight(w, spec)
            forms["block"] = G.prepare_weight(w, spec, mesh)
            assert forms["block"].tp == tp
            with _rules(mesh):       # a weight prepared for no mesh
                try:
                    AL.gemm(x, whole, spec)
                    raise AssertionError("a whole weight passed on a mesh")
                except ValueError:
                    pass
        want = AL.gemm(x, whole if spec else w, spec)
        for name, wt in forms.items():
            with _rules(mesh):
                got = AL.gemm(x, wt, spec)
                block = AL.gemm(x, wt, spec, gather=False)
                assert AL.column_split(wt) == tp
            assert torch.equal(got, want), (mult, name)
            assert torch.equal(block, mesh.shard_cols(want)), (mult, name)
    return out


def trace(vocab: int, sampled: bool = False) -> list[Request]:
    """The reference's trace (tests/test_distributed.py): prompts of 5, 19
    and 33 tokens, 6 new tokens; `sampled` makes r1 a seeded sampled
    request (tests/test_serving_paged.py)."""
    rng = np.random.default_rng(5)
    out = []
    for i, n in enumerate([5, 19, 33]):
        sp = SamplingParams(max_new_tokens=6)
        if sampled and i % 2:
            sp = SamplingParams(temperature=0.9, top_k=8, max_new_tokens=6,
                                seed=40 + i)
        out.append(Request(f"r{i}", rng.integers(1, min(vocab, 256),
                                                 (n,)).tolist(), sp))
    return out


def model(arch: str, mult: str, device=CPU, **over):
    cfg = configs.reduced(configs.get_config(arch), mult=mult,
                          kernel_policy="pallas", **over)
    return cfg, api.init_params(cfg, 0, device)


def _completions(eng) -> dict:
    return {c.request_id: {"tokens": list(c.tokens),
                           "finish": c.finish_reason,
                           "ticks": (c.admitted_tick, c.finished_tick)}
            for c in eng.completions}


def _untimed(stats: dict) -> dict:
    out = {}
    for k, v in stats.items():
        if k in TIMING:
            continue
        out[k] = _untimed(v) if isinstance(v, dict) else v
    return out


def serve(cfg, params, mesh=None, paged: bool = False,
          sampled: bool = False, target=None, device=CPU) -> dict:
    kw = dict(page_size=8, prefill_chunk=8, draft_tier=cfg.mult,
              spec_k=3) if paged else {}
    cls = PagedEngine if paged else Engine
    eng = cls(cfg, params, capacity=3, max_len=64, seed=0, device=device,
              mesh=mesh, target=target, **kw)
    for r in trace(cfg.vocab, sampled):
        eng.submit(r)
    eng.run_until_complete()
    return {"done": _completions(eng), "stats": _untimed(eng.stats())}


def logits_run(cfg, params, mesh=None, steps: int = 3) -> list:
    """Prefill of the trace's 33-token prompt, then `steps` greedy decode
    steps: every step's logits (under the mesh's rules where given)."""
    spec = api.make_spec(cfg, device=CPU)
    exec_params = api.prepare_params(params, cfg, spec, mesh=mesh)
    tokens = torch.tensor([trace(cfg.vocab)[2].tokens])
    with (_rules(mesh) if mesh is not None else contextlib.nullcontext()):
        lg, cache = api.prefill(exec_params, tokens, cfg, spec, max_len=48)
        out = [lg]
        for _ in range(steps):
            tok = torch.argmax(out[-1], dim=-1)[:, None]
            lg, cache = api.decode_step(exec_params, cache, tok, cfg, spec)
            out.append(lg[:, -1])
    return out


def engine_world(mesh, paged: bool = False) -> dict:
    """The slot engine on every ENGINE_CASES model, its logits, and (with
    `paged`) the paged engine against the slot engine on this mesh, the
    sampled requests included."""
    out = {}
    for arch, mult in ENGINE_CASES:
        cfg, params = model(arch, mult)
        out[(arch, mult)] = {"slot": serve(cfg, params, mesh),
                             "logits": logits_run(cfg, params, mesh)}
        if paged:
            out[(arch, mult)]["slot_sampled"] = serve(cfg, params, mesh,
                                                      sampled=True)
            out[(arch, mult)]["paged"] = serve(cfg, params, mesh,
                                               paged=True, sampled=True)
    return out


def calibrate_world(mesh) -> dict:
    """`calibrate_serving` on a model=2 spec and on a two-die target, and
    the slot engine built from that target (it serves)."""
    die = acc.nvdla_default(64, 7)
    two = tg.HardwareTarget(die, 2, (("data", 1), ("model", 2)))
    out = {}
    for name, kw in (("spec", dict(mesh_spec="model=2")),
                     ("target", dict(target=two))):
        c = cal.calibrate_serving(requests=2, capacity=2, max_len=32,
                                  prompt=6, gen=3, device=CPU, **kw)
        out[name] = {"measured": c.measured, "analytical": c.analytical,
                     "scale": c.scale, "anchor": c.anchor,
                     "source": c.source, "meta": c.meta}
    cfg, params = model("tinyllama-1.1b", "trunc2x2")
    out["target_engine"] = serve(cfg, params, target=two)
    return out


def calibrate_spec_world(mesh) -> tuple:
    """`calibrate_serving(mesh_spec="model=2")`: n_dies, anchor, and the
    measured rate every rank returns."""
    c = cal.calibrate_serving(requests=1, gen=2, mesh_spec="model=2",
                              device=CPU)
    return c.meta["n_dies"], c.anchor, c.measured


def target_world(mesh) -> dict:
    """The slot engine built from a two-die target inside a world of two
    (one die == one TP shard)."""
    die = acc.nvdla_default(256, 7)
    two = tg.HardwareTarget(die, n_dies=2, mesh_axes=(("model", 2),))
    cfg, params = model("tinyllama-1.1b", "trunc2x2")
    return serve(cfg, params, target=two)


def cuda_world(mesh) -> dict:
    """On the card (ranks sharing it): the TP GEMM through the kernels at
    decode and prefill shapes, bit-equal to the one-device GEMM, and the
    reduced TinyLlama (flash) served under trunc2x2."""
    dev = mesh.device
    torch.backends.cuda.matmul.allow_tf32 = False
    for mult in ("trunc2x2", "pareto:0.02:r2"):
        spec = G.spec_from_name(mult).to(dev)
        for m, k, n in ((4, 256, 512), (128, 512, 256)):
            a, b = (t.to(dev) for t in operands(m, k, n))
            one = ops.approx_qgemm_replicated(a, b, spec)
            got = ops.approx_qgemm_tp(a, mesh.shard_cols(b), spec, mesh)
            assert torch.equal(got, one), (mult, m, k, n)
    cfg, params = model("tinyllama-1.1b", "trunc2x2", dev,
                        attn_impl="flash")
    return serve(cfg, params, mesh, device=dev)


def failing_world(mesh) -> None:
    """Rank 1 raises while rank 0 waits on it in a collective."""
    if mesh.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    torch.distributed.barrier()


def hanging_world(mesh) -> None:
    """Rank 0 never returns."""
    if mesh.rank == 0:
        time.sleep(600)
