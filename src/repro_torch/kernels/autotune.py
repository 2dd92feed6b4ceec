"""Measured split and tile autotuner for the approximate-GEMM kernels.

The JAX package's `kernels/autotune.py`, for the port's kernels: the
knobs a plan may set are those the CUDA kernels take at run time, and
each winner is measured on the card it is keyed on.

* **candidate generation** — `candidate_plans` enumerates the knobs of
  the fused path's kernel for the shape: the skinny kernel's split of K
  (1, 2, 4, ... up to its 128-byte boxes) at m <= SKINNY_MAX_M, plane 0's
  (1, 2, 4, ... up to its K tiles) at one plane, the fused low-rank
  kernel's tile width (64 or 128) above.  The space is small (at most
  about nine plans), so every plan in it is timed; the JAX package ranks
  its larger space with its roofline model and times the top few.  The
  static plan (`static_candidate`) is timed first and keeps a tie, so
  tuning can only tie or win.

* **measurement** — `tune_gemm` times every candidate, the stacked
  kernel at both tile widths and the plain path (`measure_real`), and
  elects the fastest KERNEL path: the plain path's time is recorded in
  `us["xla"]` as the yardstick, never elected, since a CUDA GEMM runs on
  the kernels.  The measurement function is injectable
  (`measure(path, m, k, n, cand) -> seconds`), so tests drive the tuner
  with a seeded stub and never depend on timer noise.

* **a versioned on-disk cache** — winners persist to JSON
  ($REPRO_TUNING_CACHE, default ./TUNING_gemm_torch.json) keyed by
  (device name, SM count, shape bucket, mode, rank) and stamped with the
  schema, this package's name and the kernel library's digest
  (`build._digest` of csrc/ and the nvcc flags): editing a kernel makes
  every entry invisible, and a file the JAX package stamped reads as
  stale.  Any mismatch or a corrupt file reads as an empty cache, so
  dispatch takes its static plan.  Writes are atomic (tmp +
  os.replace).

`dispatch.choose_gemm_path` consults `lookup()` once per (policy, shape,
mode, rank, device) and memoizes the plan for the process; every save
here bumps `generation`, which clears that memo.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import tempfile

from repro_torch.kernels import approx_qgemm as qk

#: Bump when the cache layout changes (entries under old schemas are
#: discarded wholesale).
CACHE_SCHEMA = 1
#: The stamp that tells this package's cache files from the JAX package's.
PACKAGE = "repro_torch"

_ENV_VAR = "REPRO_TUNING_CACHE"
DEFAULT_CACHE_FILENAME = "TUNING_gemm_torch.json"

PATHS = ("fused", "stacked", "xla")
#: The paths a tuned entry may hold: the kernels'.
KERNEL_PATHS = ("fused", "stacked")

#: The low-rank kernels' tile widths (csrc/qgemm.cu lowrank_kernel<BN>).
BN_CANDIDATES = (64, 128)

#: Saves made by this process: dispatch's plan memo is stamped with it.
generation = 0


def cache_path() -> str:
    """Active tuning-cache path: $REPRO_TUNING_CACHE or
    ./TUNING_gemm_torch.json."""
    return os.environ.get(_ENV_VAR, "").strip() or DEFAULT_CACHE_FILENAME


def _pow2_ceil(x: int, cap: int) -> int:
    return min(cap, max(1, 1 << max(x - 1, 0).bit_length()))


def shape_bucket(m: int, k: int, n: int) -> str:
    """Shape-bucket key: pow2-ceiling per dim.  Decode GEMMs (m <= 32) get
    per-pow2 m buckets — m=1 and m=32 decode steps genuinely want
    different plans — while K/N bucket coarsely (cap 8192)."""
    return f"m{_pow2_ceil(m, 8192)}_k{_pow2_ceil(k, 8192)}" \
           f"_n{_pow2_ceil(n, 8192)}"


def entry_key(device_key: str, bucket: str, mode: str, rank: int) -> str:
    return f"{device_key}|{bucket}|{mode}|r{rank}"


@dataclasses.dataclass(frozen=True)
class Card:
    """What a tuning is keyed on: the card's name and SM count (the
    kernels' shared memory is fixed per variant, so no budget axis)."""
    name: str
    sm_count: int

    @property
    def key(self) -> str:
        return f"{self.name}|sm{self.sm_count}"


def card_of(device) -> Card:
    """The Card of a CUDA device, read from it."""
    from repro_torch import device as D
    return Card(D.device_name(device), D.sm_count(device))


@functools.lru_cache(maxsize=1)
def kernel_version() -> str:
    """The kernel library's digest: its sources and nvcc flags."""
    from repro_torch.kernels import build
    return build._digest(build.sources())


@dataclasses.dataclass(frozen=True)
class TunedPlan:
    """One cache entry: the measured winner for a (card, bucket, mode,
    rank) cell, the per-path medians that elected it (`us`, the plain
    path's under "xla") and every timed candidate's (`candidates`, by
    `Candidate.label`; `static` names the static plan's)."""
    path: str                 # "fused" | "stacked"
    bn: int                   # the low-rank kernels' tile width
    splits: int | None = None  # plane 0's or skinny's split of K
    skinny: bool = False
    us: dict = dataclasses.field(default_factory=dict)
    candidates: dict = dataclasses.field(default_factory=dict)
    static: str = ""
    source: str = "measured"

    @property
    def label(self) -> str:
        """The winner's `Candidate.label`."""
        return Candidate(self.path, self.bn, self.splits, self.skinny).label

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "TunedPlan":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


# ---------------------------------------------------------------------------
# cache persistence
# ---------------------------------------------------------------------------

def _empty_cache() -> dict:
    return {"schema": CACHE_SCHEMA, "package": PACKAGE,
            "kernel_version": kernel_version(), "entries": {}}


def load_cache(path: str | None = None) -> dict:
    """Read the tuning cache; corrupt/missing/stale files yield an empty
    cache (defaults win — never an exception on the dispatch path)."""
    path = path or cache_path()
    try:
        with open(path) as f:
            raw = json.load(f)
    except (OSError, ValueError):
        return _empty_cache()
    if not isinstance(raw, dict) \
            or raw.get("schema") != CACHE_SCHEMA \
            or raw.get("package") != PACKAGE \
            or raw.get("kernel_version") != kernel_version() \
            or not isinstance(raw.get("entries"), dict):
        return _empty_cache()
    return raw


def save_cache(cache: dict, path: str | None = None) -> str:
    """Atomic write (tmp + rename): concurrent readers see either the old
    or the new file, never a torn one."""
    global generation
    path = path or cache_path()
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=".tuning.", suffix=".json", dir=d)
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(cache, f, indent=2, sort_keys=True)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    _MEMO.pop(os.path.abspath(path), None)
    generation += 1
    return path


def put(plan: TunedPlan, m: int, k: int, n: int, mode: str, rank: int, *,
        device_key: str, path: str | None = None) -> str:
    """Merge one winner into the on-disk cache (read-modify-replace)."""
    path = path or cache_path()
    cache = load_cache(path)
    key = entry_key(device_key, shape_bucket(m, k, n), mode, rank)
    cache["entries"][key] = plan.as_dict()
    return save_cache(cache, path)


#: path -> (mtime_ns, entries): the JSON parse stays off repeated lookups.
_MEMO: dict[str, tuple[int, dict]] = {}


def entries(path: str | None = None) -> dict:
    """The cache's entries (empty for a missing, corrupt or stale file)."""
    apath = os.path.abspath(path or cache_path())
    try:
        mtime = os.stat(apath).st_mtime_ns
    except OSError:
        _MEMO.pop(apath, None)
        return {}
    hit = _MEMO.get(apath)
    if hit is not None and hit[0] == mtime:
        return hit[1]
    found = load_cache(apath)["entries"]
    _MEMO[apath] = (mtime, found)
    return found


def lookup(m: int, k: int, n: int, mode: str, rank: int, *,
           device_key: str, path: str | None = None) -> TunedPlan | None:
    """Cache hit for this GEMM's bucket on this card, or None (dispatch
    falls back to the static plan)."""
    found = entries(path)
    if not found:
        return None
    d = found.get(entry_key(device_key, shape_bucket(m, k, n), mode,
                              rank))
    if not isinstance(d, dict) or d.get("path") not in KERNEL_PATHS:
        return None
    try:
        return TunedPlan.from_dict(d)
    except TypeError:
        return None


# ---------------------------------------------------------------------------
# candidate generation
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Candidate:
    """One plan the tuner may time: a path and the knobs its kernel takes
    (`splits` on plane 0 and skinny, `bn` on the low-rank kernels)."""
    path: str = "fused"
    bn: int = 64
    splits: int | None = None
    skinny: bool = False

    @property
    def label(self) -> str:
        if self.path == "stacked":
            return f"stacked/bn{self.bn}"
        if self.skinny:
            return f"skinny/s{self.splits}"
        if self.splits is not None:
            return f"plane0/s{self.splits}"
        return f"fused/bn{self.bn}"


def _pow2s(limit: int) -> list[int]:
    out, s = [], 1
    while s <= limit:
        out.append(s)
        s *= 2
    return out


def static_candidate(m: int, k: int, n: int, n_planes: int, *,
                     sm_count: int) -> Candidate:
    """The fused path's plan with no tuning: the knobs the wrappers choose
    themselves on a card of `sm_count` SMs, at the shapes `ops` pads to."""
    from repro_torch.kernels import qgemm

    if m <= qk.SKINNY_MAX_M:
        kp = -(-k // qk.SKINNY_TILE[0]) * qk.SKINNY_TILE[0]
        return Candidate("fused", qk.SKINNY_BM, qgemm.skinny_splits(
            kp, n, sm_count=sm_count)[0], skinny=True)
    if n_planes == 1:
        mp, kp, np_ = (-(-x // t) * t for x, t in
                       zip((m, k, n), qk.PLANE0_TILE))
        return Candidate("fused", qk.PLANE0_TILE[2], qgemm.plane0_splits(
            mp, kp, np_, sm_count=sm_count)[0])
    return Candidate("fused", qk.fused_tile(n)[2])


def candidate_plans(m: int, k: int, n: int, n_planes: int, *,
                    sm_count: int) -> list[Candidate]:
    """Every plan of the fused path for an (m, k, n) GEMM with `n_planes`
    planes on a card of `sm_count` SMs: the static plan first, then the
    rest of the knob's space in increasing order."""
    from repro_torch.kernels import qgemm

    static = static_candidate(m, k, n, n_planes, sm_count=sm_count)
    if m <= qk.SKINNY_MAX_M:
        kp = -(-k // qk.SKINNY_TILE[0]) * qk.SKINNY_TILE[0]
        space = [Candidate("fused", qk.SKINNY_BM, s, skinny=True)
                 for s in _pow2s(-(-kp // qk.SKINNY_BOX))]
    elif n_planes == 1:
        space = [Candidate("fused", qk.PLANE0_TILE[2],
                           qgemm.plane0_split_plan(k, s)[0])
                 for s in _pow2s(-(-k // qk.PLANE0_TILE[1]))]
    else:
        space = [Candidate("fused", bn) for bn in BN_CANDIDATES]
    return [static, *dict.fromkeys(c for c in space if c != static)]


#: The stacked kernel's candidates: its tile widths.
STACKED_CANDIDATES = tuple(Candidate("stacked", bn) for bn in BN_CANDIDATES)


# ---------------------------------------------------------------------------
# measurement
# ---------------------------------------------------------------------------

def _median(xs: list[float]) -> float:
    ys = sorted(xs)
    h = len(ys) // 2
    return ys[h] if len(ys) % 2 else 0.5 * (ys[h - 1] + ys[h])


#: Most weight copies a timed run rotates over.
MAX_COPIES = 256


def measure_real(spec, device, *, reps: int = 5, seed: int = 0):
    """The measurement function for a MultSpec on a CUDA device: seconds
    per call of a path at a candidate's knobs, on seeded int8 operands.

    A warm-up call (which builds the library, sets each kernel's shared
    memory and grows the skinny kernel's scratch) runs on a side stream;
    then a CUDA graph captures a run of calls, one per copy of the weight,
    over enough copies that the weights of the run exceed twice the card's
    L2 cache (a serving step reads each weight once: an L2-hot timing
    would tune for a cache a real step never has); CUDA events time
    `reps` replays, and the median per call is returned.  The graph keeps
    the host out of the timing.  The fused path reads the weight K-major,
    as a prepared weight keeps it; the stacked path builds its stacks per
    call, as `ops.approx_qgemm(fused=False)` does.  Signature (the stub
    contract for tests): measure(path, m, k, n, cand) -> seconds."""
    import torch

    from repro_torch.approx import gemm as G
    from repro_torch.kernels import ops

    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"measure_real times the kernels on a CUDA device, "
                         f"not {dev}")
    spec = spec.to(dev)
    lowrank = spec.mode == "lowrank" and spec.rank > 0
    l2 = torch.cuda.get_device_properties(dev).L2_cache_size

    def measure(path: str, m: int, k: int, n: int, cand) -> float:
        gen = torch.Generator(device=dev).manual_seed(seed)
        a = torch.randint(-128, 128, (m, k), generator=gen, device=dev,
                          dtype=torch.int8)
        streamed = m * k + 4 * m * n
        copies = 1 if streamed >= 2 * l2 else \
            min(MAX_COPIES, max(1, -(-2 * l2 // (k * n))))
        ws = [torch.randint(-128, 128, (k, n), generator=gen, device=dev,
                            dtype=torch.int8) for _ in range(copies)]
        if path == "xla":
            def call(i):
                return G.approx_qgemm(a, ws[i], spec)
        elif path == "stacked":
            def call(i):
                return ops.approx_qgemm(a, ws[i], spec, fused=False,
                                        bn=cand.bn)
        else:
            wts = [w.T.contiguous() for w in ws]
            bn = cand.bn if lowrank and not cand.skinny else None

            def call(i):
                return ops.approx_qgemm(a, ws[i], spec, b_t=wts[i], bn=bn,
                                        skinny=cand.skinny,
                                        splits=cand.splits)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            call(0)
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for i in range(copies):
                call(i)
        graph.replay()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        samples = []
        for _ in range(max(reps, 1)):
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            samples.append(start.elapsed_time(end) / 1e3 / copies)
        del graph
        return _median(samples)

    return measure


def tune_gemm(m: int, k: int, n: int, spec=None, *, mode: str | None = None,
              rank: int | None = None, measure=None, device=None,
              card: Card | None = None, reps: int = 5, seed: int = 0,
              persist: bool = True, path: str | None = None) -> TunedPlan:
    """Tune one (shape, spec) cell: every fused candidate, the stacked
    kernel at each tile width and the plain path, measured;
    the fastest kernel path's plan persisted.

    Pass `spec` (a MultSpec) and a CUDA `device` for real measurement
    (a CPU device raises: there is nothing to measure there), or
    `mode`/`rank` plus a `measure` stub and a `card` for deterministic
    testing."""
    if spec is not None:
        mode = spec.mode
        rank = spec.rank if spec.mode == "lowrank" else 0
    if mode is None or rank is None:
        raise ValueError("tune_gemm needs a spec, or mode and rank")
    if measure is None:
        from repro_torch.device import resolve_device
        dev = resolve_device(device)
        if dev.type != "cuda" or spec is None:
            raise ValueError(f"tune_gemm measures a spec's kernels on a "
                             f"CUDA device; {dev} has none to measure")
        measure = measure_real(spec, dev, reps=reps, seed=seed)
        card = card or card_of(dev)
    elif card is None:
        raise ValueError("a measure stub needs the card it stands for")
    n_planes = 1 + rank
    timed = {c: measure(c.path, m, k, n, c) for c in
             [*candidate_plans(m, k, n, n_planes, sm_count=card.sm_count),
              *STACKED_CANDIDATES]}
    best: dict[str, Candidate] = {}
    for c, t in timed.items():           # the first of equal times wins
        if c.path not in best or t < timed[best[c.path]]:
            best[c.path] = c
    us = {p: timed[c] * 1e6 for p, c in best.items()}
    us["xla"] = measure("xla", m, k, n, None) * 1e6
    plan = _elect(m, k, n, n_planes, us, best, card,
                  {c.label: t * 1e6 for c, t in timed.items()})
    if persist:
        put(plan, m, k, n, mode, rank, device_key=card.key, path=path)
    return plan


def _elect(m: int, k: int, n: int, n_planes: int, us: dict, plans: dict,
           card: Card, candidates: dict) -> TunedPlan:
    """The fastest kernel path of `us` (ties to the earlier of PATHS) as
    a TunedPlan at `plans[path]`'s knobs, else at the path's static ones."""
    kernels = [p for p in us if p in KERNEL_PATHS]
    if not kernels:
        raise ValueError(f"no kernel path among the timings {us}")
    winner = min(kernels, key=lambda p: (us[p], PATHS.index(p)))
    static = static_candidate(m, k, n, n_planes, sm_count=card.sm_count)
    c = plans.get(winner) or (
        static if winner == "fused"
        else Candidate("stacked", qk.fused_tile(n)[2]))
    return TunedPlan(winner, c.bn, c.splits, c.skinny, dict(us),
                     dict(candidates), static.label)


def record_winner(m: int, k: int, n: int, mode: str, rank: int,
                  us: dict, *, card: Card, plans: dict | None = None,
                  path: str | None = None) -> TunedPlan:
    """Elect + persist a winner from EXTERNALLY measured per-path medians
    (µs): the fastest kernel path, at `plans[path]`'s knobs where given
    (else the path's static ones on `card`).  A plain-path time ("xla")
    is recorded, never elected."""
    plan = _elect(m, k, n, 1 + rank, us, dict(plans or {}), card, {})
    put(plan, m, k, n, mode, rank, device_key=card.key, path=path)
    return plan
