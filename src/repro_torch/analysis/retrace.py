"""RT: launch, build and one-time-work budgets of the port's steps.

The JAX package's retrace sanitizer counts compiles against declared
budgets.  The port compiles nothing per call; what its steps must keep
to is what a CUDA graph over them needs (ROADMAP Queue 2): a known
number of kernel launches, the kernel library built once, no one-time
work once warm, and a declared number of host syncs.  A watch counts,
per call of a watched step:

* kernel launches, from the wrappers' `.launches` counters;
* kernel library builds or loads (`build.loads`);
* dispatch plan resolutions (`dispatch.plan_misses`, memo misses);
* skinny scratch growth (`qgemm.scratch_grows`);
* first-use `cudaFuncSetAttribute` calls (`build.attr_calls`, the
  library's query);
* on the card, host syncs: the operations
  `torch.cuda.set_sync_debug_mode("warn")` reports and explicit
  `torch.cuda.synchronize` calls, each with its file and line.

and holds them to the step's `Budget`:

* RT201 — a call's launches or host syncs differ from its budget, or the
  watch built the library more often than its budget;
* RT202 — a repeat call with unchanged shapes (a signature seen before)
  did one-time work: the step is not warm.

`engine_budgets(engine)` states each engine's budgets from the launch
formulas (`step_launches`) and the engine's declared `HOST_SYNCS`;
`instrument_engine(engine)` installs the watch; `check()` drives micro
workloads (a reduced TinyLlama slot engine with greedy and sampled
requests, the batched GA for three generations, repeat GEMM calls).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
import warnings
from typing import Any, Callable, Hashable

from repro_torch.analysis.findings import Finding

#: The kernel wrappers, by kernel name (module, attribute): a watch reads
#: each one's `.launches` through the module, so a counting shim set there
#: is read.
KERNELS = {"quantize_rows": ("quantize", "quantize_rows"),
           "approx_qgemm_plane0": ("qgemm", "approx_qgemm_plane0"),
           "approx_qgemm_skinny": ("qgemm", "approx_qgemm_skinny"),
           "flash_attention": ("flash_attention", "flash_attention"),
           "approx_qgemm_fused": ("qgemm", "approx_qgemm_fused"),
           "approx_qgemm_stacked": ("qgemm", "approx_qgemm_stacked")}
ONE_TIME = ("builds", "plan_misses", "scratch_grows", "attr_calls")
#: Kernel library builds (or loads) a process makes: one.
BUILDS = 1
_SYNC_WARNING = "synchronizing CUDA operation"


def launch_counts() -> dict[str, int]:
    import importlib
    out = {}
    for name, (mod, attr) in KERNELS.items():
        m = importlib.import_module(f"repro_torch.kernels.{mod}")
        out[name] = getattr(m, attr).launches
    return out


def _snapshot() -> dict:
    from repro_torch.kernels import build, dispatch, qgemm
    return {"launches": launch_counts(), "builds": build.loads,
            "plan_misses": dispatch.plan_misses,
            "scratch_grows": qgemm.scratch_grows,
            "attr_calls": build.attr_calls()}


def _site(filename: str, line: int) -> str:
    parts = filename.replace(os.sep, "/").split("/src/")
    return f"{parts[-1]}:{line}"


@contextlib.contextmanager
def recording_syncs(sites: list[str]):
    """Append to `sites` the file:line of every host sync in the block:
    what `torch.cuda.set_sync_debug_mode("warn")` reports (a blocking copy
    either way, `.item()`, an op sized by its data), and explicit
    `torch.cuda.synchronize` calls, which it does not report.  Other
    warnings raised in the block are passed on."""
    import torch
    real = torch.cuda.synchronize

    def counted(*args, **kwargs):
        f = sys._getframe(1)
        sites.append(_site(f.f_code.co_filename, f.f_lineno))
        return real(*args, **kwargs)

    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.synchronize = counted
    try:
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                yield sites
            finally:
                torch.cuda.set_sync_debug_mode(prev)
    finally:
        torch.cuda.synchronize = real
    for r in rec:
        if _SYNC_WARNING in str(r.message):
            sites.append(_site(r.filename, r.lineno))
        elif "debug mode is a prototype" not in str(r.message):
            warnings.warn_explicit(r.message, r.category, r.filename,
                                   r.lineno)


@dataclasses.dataclass
class Budget:
    """What one call of a watched step may do.  `launches` is the exact
    launches per kernel (a dict, or a function of the call's arguments
    giving one; None: unchecked); `syncs` the exact host syncs a call
    makes on the card (None: unchecked); `signature` maps a call's
    arguments to its shapes (None: every call alike): a call whose
    signature was seen before is a repeat and may do no one-time work.
    A watch may see `BUILDS` library builds in all."""
    launches: dict | Callable[..., dict] | None = None
    syncs: int | None = None
    signature: Callable[..., Hashable] | None = None


@dataclasses.dataclass
class _Watch:
    name: str
    fn: Any
    budget: Budget
    syncs: bool                   # count host syncs (on the card)
    calls: list = dataclasses.field(default_factory=list)
    seen: set = dataclasses.field(default_factory=set)


class _Proxy:
    """Callable wrapper recording one `_Watch` entry per call."""

    def __init__(self, watch: _Watch):
        self._watch = watch

    def __call__(self, *args, **kwargs):
        w, b = self._watch, self._watch.budget
        sig = b.signature(*args, **kwargs) if b.signature else ()
        want = b.launches(*args, **kwargs) if callable(b.launches) \
            else b.launches
        before = _snapshot()
        sites: list[str] = []
        ctx = recording_syncs(sites) if w.syncs else contextlib.nullcontext()
        with ctx:
            out = w.fn(*args, **kwargs)
        after = _snapshot()
        rec = {"call": len(w.calls) + 1, "signature": sig,
               "repeat": sig in w.seen,
               "launches": {k: after["launches"][k] - before["launches"][k]
                            for k in after["launches"]},
               "want_launches": want,
               "syncs": len(sites) if w.syncs else None, "sites": sites}
        for k in ONE_TIME:
            rec[k] = after[k] - before[k]
        w.calls.append(rec)
        w.seen.add(sig)
        return out

    def __getattr__(self, name):
        return getattr(self._watch.fn, name)


class RetraceSanitizer:
    """Watch steps against declared launch, build, one-time-work and
    host-sync budgets.  `syncs` counts host syncs on the card (None: where
    a CUDA device is present)."""

    def __init__(self, syncs: bool | None = None):
        if syncs is None:
            import torch
            syncs = torch.cuda.is_available()
        self.syncs = syncs
        self._watches: dict[str, _Watch] = {}

    def watch(self, name: str, fn: Any, budget: Budget) -> Callable:
        """Register `fn` under `budget`; returns a proxy to call instead."""
        if name in self._watches:
            raise ValueError(f"duplicate watch {name!r}")
        w = _Watch(name, fn, budget, self.syncs)
        self._watches[name] = w
        return _Proxy(w)

    def findings(self) -> list[Finding]:
        out: list[Finding] = []
        for w in self._watches.values():
            b = w.budget
            off = [c for c in w.calls if c["want_launches"] is not None
                   and c["launches"] != c["want_launches"]]
            if off:
                c = off[0]
                out.append(Finding(
                    "RT201", w.name,
                    f"{len(off)} of {len(w.calls)} calls off their launch "
                    f"budget; call #{c['call']} launched "
                    f"{_nonzero(c['launches'])}, budget "
                    f"{_nonzero(c['want_launches'])}"))
            if b.syncs is not None and w.syncs:
                bad = [c for c in w.calls if c["syncs"] != b.syncs]
                if bad:
                    c = bad[0]
                    out.append(Finding(
                        "RT201", w.name,
                        f"{len(bad)} of {len(w.calls)} calls off the "
                        f"declared {b.syncs} host syncs; call #{c['call']} "
                        f"made {c['syncs']} at {c['sites']}"))
            builds = sum(c["builds"] for c in w.calls)
            if builds > BUILDS:
                out.append(Finding(
                    "RT201", w.name,
                    f"{builds} kernel library builds (budget {BUILDS})"))
            cold = [c for c in w.calls if c["repeat"]
                    and any(c[k] for k in ONE_TIME)]
            if cold:
                c = cold[0]
                work = {k: c[k] for k in ONE_TIME if c[k]}
                out.append(Finding(
                    "RT202", w.name,
                    f"{len(cold)} repeat call(s) with unchanged shapes did "
                    f"one-time work; call #{c['call']} (signature "
                    f"{c['signature']}): {work}"))
        return out

    def report(self) -> dict:
        out = {}
        for w in self._watches.values():
            calls = w.calls
            repeats = [c for c in calls if c["repeat"]]
            out[w.name] = {
                "calls": len(calls),
                "launches_per_call": sorted({
                    tuple(sorted(_nonzero(c["launches"]).items()))
                    for c in calls}),
                "syncs_per_call": sorted({c["syncs"] for c in calls
                                          if c["syncs"] is not None}),
                "sync_sites": sorted({s for c in calls for s in c["sites"]}),
                "builds": sum(c["builds"] for c in calls),
                "one_time_after_first": {
                    k: sum(c[k] for c in repeats) for k in ONE_TIME},
                "budget_syncs": w.budget.syncs}
        return out

    def assert_ok(self) -> None:
        bad = self.findings()
        if bad:
            raise AssertionError(
                "retrace sanitizer: " + "; ".join(f.render() for f in bad))


def _nonzero(d: dict) -> dict:
    return {k: v for k, v in d.items() if v}


# --------------------------------------------------------------------------
# launch formulas: the kernel launches of one step of a model
# --------------------------------------------------------------------------

def gemm_rows(cfg, b: int, s: int, prefill: bool) -> list[int]:
    """The row count M of every approximate GEMM of one step, the LM head
    (at M = b) last: a prefill of b prompts of s tokens, or a decode step
    of b lanes (s = 1).  Per layer: 7 dense GEMMs under SwiGLU, 6 under
    the GELU MLP; mamba2's in and out projections (2); the hybrid's 6 per
    recurrent block (its w_rg / w_in run exact) and 7 per attention block;
    Whisper's 8 per decoder layer (self q, k, v, o; cross q, o; the MLP's
    two), and in prefill its encoder's 6 per layer and its cross K/V (2
    per decoder layer, made once) at M = b x enc_seq; the vision model's 4
    per cross-attention block (q, o, and the image's k, v at M = b x
    n_img_tokens, in every step).  An MoE layer runs its 4 attention GEMMs
    at M = b x s, then top_k x 3 x n_experts expert GEMMs at M = the
    call's capacity, and the shared expert's 3 at b x s; an interleaved
    model's dense layers run 7."""
    t = b * s
    if cfg.is_moe:
        from repro_torch.models import moe
        cap = moe.capacity_of(t, cfg.n_experts, cfg.top_k,
                              cfg.capacity_factor)
        moe_layer = [t] * (4 + 3 * cfg.shared_expert) + \
            [cap] * (cfg.top_k * 3 * cfg.n_experts)
        n_moe = cfg.n_layers // cfg.moe_every
        rows = moe_layer * n_moe + [t] * (7 * (cfg.n_layers - n_moe))
        return rows + [b]
    if cfg.family == "ssm":
        rows = [t] * (2 * cfg.n_layers)
    elif cfg.family == "hybrid":
        n_attn = cfg.n_layers // 3
        rows = [t] * (6 * (cfg.n_layers - n_attn) + 7 * n_attn)
    elif cfg.family == "encdec":
        rows = [t] * (8 * cfg.n_layers)
        if prefill:
            e = b * cfg.enc_seq
            rows += [e] * (6 * cfg.n_enc_layers + 2 * cfg.n_layers)
    else:
        per_layer = 7 if cfg.mlp_style == "swiglu" else 6
        rows = [t] * (per_layer * cfg.n_layers)
        if cfg.cross_every:
            n_cross = cfg.n_layers // cfg.cross_every
            rows += [t] * (2 * n_cross) + \
                [b * cfg.n_img_tokens] * (2 * n_cross)
    return rows + [b]


def flash_per_prefill(cfg, s: int) -> int:
    """Flash launches of one prefill of s tokens under attn_impl "flash":
    one per self-attention layer of an `lm`; Whisper's encoder and decoder
    layers, and its cross-attention too where s equals enc_seq; none for
    mamba2 or the windowed hybrid."""
    if cfg.attn_impl != "flash":
        return 0
    if cfg.family == "lm":
        return cfg.n_layers
    if cfg.family == "encdec":
        return cfg.n_enc_layers + cfg.n_layers * (2 if s == cfg.enc_seq
                                                  else 1)
    return 0


def step_launches(cfg, b: int, s: int, prefill: bool, *, gemms: bool = True,
                  lowrank: bool = False, flash: bool = True) -> dict:
    """Kernel launches of one step (`gemm_rows`) on the card: each GEMM
    quantizes its f32 rows once and runs skinny at M <= 32, else plane 0
    (the fused kernel for a low-rank multiplier); a prefill runs
    `flash_per_prefill` flash launches.  `gemms` False: the GEMMs run no
    kernel (the exact tier, or the plain policy); `flash` False: the
    attention runs no kernel."""
    from repro_torch.kernels import approx_qgemm as qk
    out = dict.fromkeys(KERNELS, 0)
    if gemms:
        rows = gemm_rows(cfg, b, s, prefill)
        skinny = sum(m <= qk.SKINNY_MAX_M for m in rows)
        if cfg.dtype == "float32":
            out["quantize_rows"] = len(rows)
        out["approx_qgemm_skinny"] = skinny
        tiled = "approx_qgemm_fused" if lowrank else "approx_qgemm_plane0"
        out[tiled] = len(rows) - skinny
    if flash and prefill:
        out["flash_attention"] = flash_per_prefill(cfg, s)
    return out


def _times(n: int, launches: dict) -> dict:
    return {k: n * v for k, v in launches.items()}


# --------------------------------------------------------------------------
# serving-engine instrumentation
# --------------------------------------------------------------------------

def engine_budgets(engine, on_card: bool | None = None) -> dict[str, Budget]:
    """Each watched step's budget for one engine: launches from
    `step_launches` at the engine's rows (zero off the card, where the
    wrappers run their plain versions and launch nothing), one library
    build, and on the card the engine's declared `HOST_SYNCS` (unchecked
    on a mesh of several ranks, whose collectives stage through the host).
    A step's GEMM launches follow the tier it runs at the call (its spec's
    mode and policy)."""
    from repro_torch.kernels import dispatch
    on_card = engine.device.type == "cuda" if on_card is None else on_card
    cfg = engine.cfg
    one_rank = engine.mesh is None or engine.mesh.size == 1
    syncs = dict(engine.HOST_SYNCS) if on_card and one_rank else {}
    flash = on_card and dispatch.use_pallas_attention(cfg.kernel_policy,
                                                      engine.device)

    def launches(b: int, s: int, prefill: bool, spec, times: int = 1):
        if not on_card:
            return dict.fromkeys(KERNELS, 0)
        gemms = spec is not None and not spec.is_exact and \
            dispatch.use_kernels(spec.policy, engine.device)
        return _times(times, step_launches(
            cfg, b, s, prefill, gemms=gemms, flash=flash,
            lowrank=spec is not None and spec.mode == "lowrank"))

    def bucket(request) -> int:
        return next(b for b in engine.buckets if b >= len(request.tokens))

    rows = engine._rows
    out = {
        "serving/engine:decode": Budget(
            launches=lambda: launches(rows, 1, False, engine._spec),
            syncs=syncs.get("decode")),
        "serving/engine:prefill": Budget(
            launches=lambda request, *a, **k: launches(
                1, bucket(request), True, engine._spec),
            syncs=syncs.get("prefill"),
            signature=lambda request, *a, **k: bucket(request)),
    }
    if getattr(engine, "prefill_chunk", None):
        c = engine.prefill_chunk

        def take(job) -> int:
            return min(c, len(job.request.tokens) - job.pos)

        out["serving/paged:first_chunk"] = Budget(
            launches=lambda *a, **k: launches(1, c, True, engine._spec),
            syncs=syncs.get("chunk"))
        out["serving/paged:chunk"] = Budget(
            launches=lambda job: launches(1, 1, False, engine._spec,
                                          times=take(job)),
            syncs=syncs.get("chunk"), signature=take)
    if getattr(engine, "draft_tier", None) is not None:
        k = engine.spec_k
        out["serving/paged:draft"] = Budget(
            launches=lambda: launches(rows, 1, False, engine._draft_spec,
                                      times=k),
            syncs=syncs.get("draft"))
        out["serving/paged:verify"] = Budget(
            launches=lambda *a, **kw: launches(rows, 1, False, engine._spec,
                                               times=k),
            syncs=syncs.get("verify"))
    return out


#: watch name -> the engine method it wraps
_ENGINE_STEPS = {"serving/engine:decode": "_decode",
                 "serving/engine:prefill": "_admit",
                 "serving/paged:first_chunk": "_start_chunked",
                 "serving/paged:chunk": "_advance_one",
                 "serving/paged:draft": "_draft_tokens",
                 "serving/paged:verify": "_verify"}


def instrument_engine(engine, sanitizer: RetraceSanitizer | None = None,
                      on_card: bool | None = None) -> RetraceSanitizer:
    """Swap an engine's steps for watched proxies (instance attributes).
    Run it before the engine serves traffic: budgets count from here.
    `on_card` is `engine_budgets`'; host syncs are counted where the
    engine runs on a CUDA device."""
    s = sanitizer or RetraceSanitizer(syncs=engine.device.type == "cuda")
    for name, budget in engine_budgets(engine, on_card).items():
        method = _ENGINE_STEPS[name]
        setattr(engine, method, s.watch(name, getattr(engine, method),
                                        budget))
    return s


# --------------------------------------------------------------------------
# CLI checker: micro workloads that prove the budgets hold end to end
# --------------------------------------------------------------------------

def _check_serving(dev) -> list[Finding]:
    from repro_torch import configs
    from repro_torch.serving import Engine, Request, SamplingParams

    cfg = configs.apply_overrides(
        configs.get_config("tinyllama-1.1b", mult="trunc2x2",
                           kernel_policy="pallas"), reduced=True)
    eng = Engine(cfg, capacity=2, max_len=48, seed=0, device=dev)
    s = instrument_engine(eng)
    for i, (n, temp) in enumerate([(4, 0.0), (9, 0.8), (6, 0.0),
                                   (12, 1.1)]):
        eng.submit(Request(
            f"rt{i}", list(range(1, n + 1)),
            SamplingParams(max_new_tokens=4, temperature=temp,
                           top_k=8 if temp else 0, seed=i),
            arrival=float(i)))
    eng.run_until_complete()
    return s.findings()


def _check_ga(dev) -> list[Finding]:
    """The batched GA's step across three generations: no launch of the
    kernels, no one-time work, and none of the host syncs it was written
    without ("with no sync to the host")."""
    import torch
    from repro_torch.core import ga_batched as gb
    from repro_torch.core import multipliers as mm

    s = RetraceSanitizer(syncs=dev.type == "cuda")
    step = s.watch("core/ga_batched:step", gb._ga_step,
                   Budget(launches=dict.fromkeys(KERNELS, 0), syncs=0))
    mults = [mm.exact_multiplier(), mm.truncated(1, 1), mm.truncated(2, 2)]
    space = gb.build_space("vgg16", 14, 0.0, 2.0, mults=mults, device=dev)
    tables = space.tables(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    pop = gb._random_genes(gen, 32, space.gene_sizes, tables["allowed"])
    pop = gb._snap_die_gene(pop, tables["die_ok"])
    for _ in range(3):
        pop, _, _ = step(gen, pop, tables, 14, space.gene_sizes, 3, 2, 0.9,
                         0.1, 50.0)
    return s.findings()


def _check_kernels(dev) -> list[Finding]:
    """Repeat GEMM calls at one shape, primed once outside the watch: each
    launches one kernel (plane 0 at M = 128, skinny at m = 4) and no call
    does one-time work."""
    import numpy as np
    import torch
    from repro_torch.approx import gemm as G
    from repro_torch.kernels import ops

    on_card = dev.type == "cuda"
    rng = np.random.default_rng(0)
    spec = G.spec_from_name("trunc2x2").with_policy("pallas").to(dev)
    s = RetraceSanitizer(syncs=on_card)
    for m, kernel in ((128, "approx_qgemm_plane0"),
                      (4, "approx_qgemm_skinny")):
        a = torch.from_numpy(rng.integers(-127, 128, (m, 256), np.int8)
                             ).to(dev)
        b = torch.from_numpy(rng.integers(-127, 128, (256, 192), np.int8)
                             ).to(dev)

        def gemm(a=a, b=b):
            return ops.approx_qgemm_replicated(a, b, spec)

        gemm()                    # the first call plans and grows scratch
        want = dict.fromkeys(KERNELS, 0)
        want[kernel] = int(on_card)
        fn = s.watch(f"kernels/ops:approx_qgemm({m}x256x192)", gemm,
                     Budget(launches=want, syncs=0))
        for _ in range(3):
            fn()
    return s.findings()


def check(root: str | None = None, device=None) -> list[Finding]:
    """CLI entry: the micro serving / GA / GEMM workloads under watch, on
    `device` (None: the CUDA device, raising where there is none)."""
    from repro_torch.device import resolve_device
    dev = resolve_device(device)
    findings: list[Finding] = []
    findings.extend(_check_serving(dev))
    findings.extend(_check_ga(dev))
    findings.extend(_check_kernels(dev))
    return findings
