"""Rank programs of tests/test_torch_dp.py: top-level functions that
`repro_torch.launch.mesh.spawn` runs on every rank of a world (they
import torch and repro_torch only, so the ranks start without JAX), and
the one-device runs the tests hold them to.

Every program runs on the CPU at the reduced size, under gloo, and
returns host data: completions without their host times, non-timing
stats, the decode steps' logits of the rank's rows, the shapes of the
rank's arena and lanes, and a digest of every pool."""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import io

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core import accelerator as acc
from repro_torch.core import calibrate as cal
from repro_torch.core import target as tg
from repro_torch.fleet.router import FleetConfig
from repro_torch.launch import fleet as launch_fleet
from repro_torch.launch import serve as launch_serve
from repro_torch.models import api
from repro_torch.serving import Engine, PagedEngine, Request, SamplingParams

CPU = torch.device("cpu")
#: stats() entries read off a host clock: every rank has its own
TIMING = {"prefill_s", "decode_s", "collective_s", "decode_collective_s",
          "chunk_step_s"}
#: the slot engine's models at capacity 4
SLOT_ARCHS = ("tinyllama-1.1b", "mamba2-370m")
#: the paged runs at data=2, by name: PagedEngine keywords
PAGED_RUNS = {"P": dict(page_size=8),
              "PC": dict(page_size=8, prefill_chunk=8),
              "PS": dict(page_size=8, draft_tier="trunc2x2", spec_k=3)}


def model(arch: str, mult: str = "trunc2x2", **over):
    cfg = configs.reduced(configs.get_config(arch), mult=mult,
                          kernel_policy="pallas", **over)
    return cfg, api.init_params(cfg, 0, CPU)


def trace(vocab: int) -> list[Request]:
    """Six requests over a capacity-4 arena: staggered arrivals and
    lengths, so slots are freed and reused on both data ranks' rows; r3
    is a seeded sampled request; r2 shares r0's first 16 tokens (two
    pages of 8), and lands on the other data rank's rows at data=2, so
    the prefix cache is hit across ranks."""
    rng = np.random.default_rng(7)
    hi = min(vocab, 256)
    lens, arrivals, new = [20, 9, 30, 12, 26, 7], [0, 0, 0, 0, 2, 3], \
        [6, 4, 8, 5, 6, 7]
    prompts = [rng.integers(1, hi, (n,)).tolist() for n in lens]
    prompts[2][:16] = prompts[0][:16]
    out = []
    for i, (p, a, n) in enumerate(zip(prompts, arrivals, new)):
        sp = SamplingParams(max_new_tokens=n)
        if i == 3:
            sp = SamplingParams(temperature=0.9, top_k=8, max_new_tokens=n,
                                seed=43)
        out.append(Request(f"r{i}", p, sp, arrival=float(a)))
    return out


def reference_trace(vocab: int) -> list[Request]:
    """The reference's trace (tests/test_distributed.py:141): prompts of
    5, 19 and 33 tokens, 6 new tokens each."""
    rng = np.random.default_rng(5)
    return [Request(f"r{i}", rng.integers(1, min(vocab, 256), (n,)).tolist(),
                    SamplingParams(max_new_tokens=6))
            for i, n in enumerate([5, 19, 33])]


def _untimed(stats: dict) -> dict:
    out = {}
    for k, v in stats.items():
        if k in TIMING:
            continue
        out[k] = _untimed(v) if isinstance(v, dict) else v
    return out


@contextlib.contextmanager
def recording_logits():
    """Every `api.decode_step`'s last-position logits, in call order."""
    orig = api.decode_step
    rec: list = []

    def step(*args, **kw):
        logits, cache = orig(*args, **kw)
        rec.append(logits[:, -1].clone())
        return logits, cache

    api.decode_step = step
    try:
        yield rec
    finally:
        api.decode_step = orig


def pool_digests(eng) -> dict:
    """sha1 of every pool's pages past the trash page (page 0, a write
    sink whose bits no valid position reads), by leaf."""
    out = {}
    for key, axis in eng._arena.paged.items():
        pool = eng._arena.cache[key].movedim(axis, 0)[eng.page_size:]
        raw = pool.contiguous().reshape(-1).view(torch.uint8).numpy()
        out[key] = hashlib.sha1(raw.tobytes()).hexdigest()
    return out


def serve(cfg, params, mesh=None, *, capacity: int = 4, requests=None,
          paged: str | None = None) -> dict:
    """The trace through the slot engine (or the paged run `paged`) at
    `capacity`: completions, non-timing stats, every decode step's logits
    of this rank's rows, the rank's rows and the shapes of its arena and
    lanes, and (paged) the pools' digests."""
    cls, kw = (PagedEngine, PAGED_RUNS[paged]) if paged else (Engine, {})
    eng = cls(cfg, params, capacity=capacity, max_len=64, seed=0,
              device=CPU, mesh=mesh, **kw)
    for r in requests or trace(cfg.vocab):
        eng.submit(r)
    with recording_logits() as rec:
        eng.run_until_complete()
    out = {"done": {c.request_id: {"tokens": list(c.tokens),
                                   "finish": c.finish_reason,
                                   "ticks": (c.admitted_tick,
                                             c.finished_tick),
                                   "spec": c.spec and
                                   dataclasses.asdict(c.spec)}
                    for c in eng.completions},
           "stats": _untimed(eng.stats()),
           "rows": (eng._lo, eng._rows),
           "shapes": {k: tuple(v.shape)
                      for k, v in eng._arena.cache.items()},
           "lanes": {"tok": tuple(eng._tok.shape),
                     "idle": tuple(eng._idle.shape)}}
    if not paged and not cfg.is_moe:
        out["logits"] = [lg.numpy() for lg in rec]
    if paged:
        out["pools"] = pool_digests(eng)
        out["table"] = tuple(eng._table.shape)
    return out


# --- the worlds ------------------------------------------------------------------

def slot_world(mesh) -> dict:
    """The slot engine on `SLOT_ARCHS` at capacity 4, and reduced
    TinyLlama on the reference's trace at capacity 3 (rows whole)."""
    out = {}
    for arch in SLOT_ARCHS:
        cfg, params = model(arch)
        out[arch] = serve(cfg, params, mesh)
    cfg, params = model("tinyllama-1.1b")
    out["capacity3"] = serve(cfg, params, mesh, capacity=3,
                             requests=reference_trace(cfg.vocab))
    return out


def moe_world(mesh) -> dict:
    """Reduced grok-1 at capacity 4: an MoE config keeps its rows."""
    cfg, params = model("grok-1-314b")
    return serve(cfg, params, mesh)


def paged_world(mesh) -> dict:
    """Reduced TinyLlama: the slot engine and every `PAGED_RUNS` run."""
    cfg, params = model("tinyllama-1.1b")
    out = {"S4": serve(cfg, params, mesh)}
    for name in PAGED_RUNS:
        out[name] = serve(cfg, params, mesh, paged=name)
    return out


def calibrate_world(mesh) -> dict:
    """`calibrate_serving` on a data axis of two (capacity 2: one row per
    rank)."""
    c = cal.calibrate_serving(requests=2, capacity=2, max_len=32, prompt=6,
                              gen=3, mesh_spec="model=1,data=2", device=CPU)
    return {"measured": c.measured, "analytical": c.analytical,
            "scale": c.scale, "anchor": c.anchor, "n_dies": c.meta["n_dies"],
            "decode_steps": c.meta["decode_steps"],
            "decode_tokens": c.meta["decode_tokens"]}


def fleet_targets():
    """A one-die target with no mesh axes (in a world of two it serves
    data-parallel: `make_host_mesh(model=1)`) and a two-die target (one
    die == one TP shard)."""
    die = acc.nvdla_default(256, 7)
    return (tg.HardwareTarget(die),
            tg.HardwareTarget(die, n_dies=2, mesh_axes=(("model", 2),)))


def fleet_run(targets=None, mesh=None) -> dict:
    """`build_fleet` over two replicas (the `fleet_targets` in a world;
    one device in one process), eight Poisson requests, replica us-west
    killed after two fleet ticks and restarted two ticks later: what the
    fleet decided on its tick clock, every completion's tokens, and the
    meters' Joules (rank 0's and, in a world, the ranks' maximum)."""
    cfg, params = model("tinyllama-1.1b")
    fleet = launch_fleet.build_fleet(
        cfg, trace="static", capacity=2, max_len=48, params=params,
        targets=targets, device=CPU,
        fleet_cfg=FleetConfig(ttft_slo_ticks=32.0, probation_steps=1))
    reqs = launch_fleet.poisson_requests(8, 6, 6, cfg.vocab, seed=0)
    for r in reqs:
        fleet.submit(r)
    fleet.step()
    fleet.step()
    fleet.kill_replica("us-west", recovery_ticks=2)
    fleet.run_until_complete()
    joules = [r.carbon_summary()["energy_j"] for r in fleet.replicas]
    out = {"routes": [dataclasses.astuple(r) for r in fleet.routes],
           "requeue_events": fleet.requeue_events,
           "recoveries": fleet.recoveries,
           "completions": sorted(
               (c.request_id, c.finish_reason, c.arrival, c.admitted_tick,
                c.finished_tick, c.attempt, tuple(c.tokens))
               for c in fleet.completions()),
           "wall_admitted": [r.wall_admitted for r in fleet.replicas],
           "alive": [r.alive for r in fleet.replicas],
           "restarts": [r.restarts for r in fleet.replicas],
           "tick": fleet.tick, "lost": fleet.stats()["lost"],
           "joules": joules}
    if mesh is not None:
        out["meshes"] = [r.engine.stats()["mesh"] for r in fleet.replicas]
        out["rows"] = [r.engine._rows for r in fleet.replicas]
        out["joules_max"] = mesh.all_reduce_max(joules)
    return out


def cli_world(mesh) -> dict:
    """`serve --mesh data=2` and `fleet --mesh data=2` on the world (the
    group is up, so `init_from_env` joins nothing): rank 0's output and
    the exit codes."""
    out = {}
    for name, main, argv in (
            ("serve", launch_serve.main,
             ["--reduced", "--mult", "trunc2x2", "--kernel-policy", "pallas",
              "--batch", "4", "--prompt-len", "8", "--gen", "3",
              "--mesh", "data=2", "--device", "cpu"]),
            ("fleet", launch_fleet.main,
             ["--reduced", "--device", "cpu", "--mesh", "data=2",
              "--kill", "3", "--requests", "6", "--gen", "4"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
        out[name] = (rc, buf.getvalue())
    return out


def data_world(mesh) -> dict:
    """Everything the data=2 world runs, once."""
    return {"slot": slot_world(mesh), "moe": moe_world(mesh),
            "paged": paged_world(mesh), "calibrate": calibrate_world(mesh),
            "fleet": fleet_run(fleet_targets(), mesh),
            "cli": cli_world(mesh)}


def grid_world(mesh) -> dict:
    """The model=2,data=2 world: the slot engine at capacity 4 and 3."""
    return {"slot": slot_world(mesh)}
