"""NSGA-II multi-objective search for area-aware approximate multipliers.

Genome = (pruning bitmask over the prunable gates of the BW8 netlist,
          trunc_a in 0..4, trunc_b in 0..4).
Objectives = minimize (area_nand2eq, NMED).

This is the paper's step 1 ("approximations guided by a multi-objective
optimization algorithm ... near-Pareto-optimal solutions with minimal
functional error") in the spirit of [5] (genetic circuit approximation).
Deterministic under a fixed seed; the default front is cached in-process and
on disk.  The disk cache sits in the same directory as the JAX package's
($REPRO_CACHE_DIR, else `.cache` at the repository root) under a file
name of its own, so this package never reads a front the other computed.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import pathlib

import numpy as np

from . import lut as lutmod
from . import multipliers as multmod
from . import netlist as nlmod


@dataclasses.dataclass
class NSGAConfig:
    pop_size: int = 32
    generations: int = 16
    p_mut_gate: float = 0.01     # per-gene bitflip probability
    p_mut_trunc: float = 0.15
    p_crossover: float = 0.9
    max_trunc: int = 4
    nmed_cap: float = 0.08       # discard individuals worse than this
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class Individual:
    mask: np.ndarray     # (n_prunable,) bool
    trunc_a: int
    trunc_b: int
    area: float
    nmed: float

    def key(self) -> tuple:
        return (self.mask.tobytes(), self.trunc_a, self.trunc_b)


def _evaluate(mask: np.ndarray, ta: int, tb: int) -> tuple[float, float]:
    nl = nlmod.bw8()
    prunable = nl.prunable_gates()
    probs = multmod._signal_probs()
    pr: dict[int, int] = {}
    for k in np.flatnonzero(mask):
        gid = prunable[k]
        pr[gid] = int(probs[gid] >= 0.5)
    pr.update(nlmod.truncation_pruning(nl, ta, tb))
    full = nlmod.constant_propagate(nl, pr)
    lut = nlmod.netlist_lut(nl, full)
    area = nl.area_nand2eq(full)
    e = np.abs(nlmod.exact_lut().astype(np.int64) - lut.astype(np.int64))
    nmed = float(e.mean() / lutmod.MAX_ABS_PRODUCT)
    return area, nmed


def _nondominated_sort(objs: np.ndarray) -> list[np.ndarray]:
    """objs (n, m) minimize-all -> list of index arrays per front.

    i dominates j iff i is <= j on every objective and < on at least
    one (works for any m >= 1; the NSGA-II loop uses m = 2)."""
    n = len(objs)
    dominates = (np.all(objs[:, None, :] <= objs[None, :, :], axis=-1)
                 & np.any(objs[:, None, :] < objs[None, :, :], axis=-1))
    dom_count = dominates.sum(axis=0)  # how many dominate i
    fronts: list[np.ndarray] = []
    remaining = np.arange(n)
    counts = dom_count.copy()
    while len(remaining):
        cur = remaining[counts[remaining] == 0]
        if len(cur) == 0:  # numerical ties; break arbitrarily
            cur = remaining[np.argsort(counts[remaining])[:1]]
        fronts.append(cur)
        mask = np.ones(n, dtype=bool)
        mask[cur] = False
        for i in cur:
            counts[dominates[i]] -= 1
        remaining = np.array([r for r in remaining if mask[r]], dtype=int)
    return fronts


def nondominated_front(points: np.ndarray) -> np.ndarray:
    """Indices of the nondominated rows of `points` (n, m objectives,
    all minimized), sorted ascending by the first objective.

    Public surface for frontier reporting outside the NSGA loop — e.g.
    `core.codesign` extracts the (carbon, delay) frontier of a final GA
    population with it."""
    pts = np.asarray(points, dtype=float)
    if pts.ndim != 2:
        raise ValueError(f"points must be (n, m), got shape {pts.shape}")
    if len(pts) == 0:
        return np.empty((0,), dtype=int)
    front = _nondominated_sort(pts)[0]
    return front[np.argsort(pts[front, 0], kind="stable")]


def _crowding(objs: np.ndarray, front: np.ndarray) -> np.ndarray:
    d = np.zeros(len(front))
    for m in range(objs.shape[1]):
        order = front[np.argsort(objs[front, m])]
        lo, hi = objs[order[0], m], objs[order[-1], m]
        span = max(hi - lo, 1e-12)
        pos = {int(idx): k for k, idx in enumerate(order)}
        for k, idx in enumerate(front):
            p = pos[int(idx)]
            if p == 0 or p == len(order) - 1:
                d[k] = np.inf
            else:
                d[k] += (objs[order[p + 1], m] - objs[order[p - 1], m]) / span
    return d


def nsga2(cfg: NSGAConfig | None = None) -> list[Individual]:
    """Run NSGA-II; returns the final nondominated front sorted by area."""
    cfg = cfg or NSGAConfig()
    rng = np.random.default_rng(cfg.seed)
    nl = nlmod.bw8()
    n_genes = len(nl.prunable_gates())

    def random_ind() -> tuple[np.ndarray, int, int]:
        density = rng.uniform(0.0, 0.08)
        mask = rng.random(n_genes) < density
        return mask, int(rng.integers(0, cfg.max_trunc + 1)), \
            int(rng.integers(0, cfg.max_trunc + 1))

    def make(mask: np.ndarray, ta: int, tb: int) -> Individual:
        area, nmed = _evaluate(mask, ta, tb)
        return Individual(mask, ta, tb, area, nmed)

    pop = [make(*random_ind()) for _ in range(cfg.pop_size)]
    pop.append(make(np.zeros(n_genes, dtype=bool), 0, 0))  # seed exact

    for _gen in range(cfg.generations):
        objs = np.array([[p.area, p.nmed] for p in pop])
        fronts = _nondominated_sort(objs)
        rank = np.zeros(len(pop), dtype=int)
        for fi, fr in enumerate(fronts):
            rank[fr] = fi
        crowd = np.zeros(len(pop))
        for fr in fronts:
            crowd[fr] = _crowding(objs, fr)

        def tournament() -> Individual:
            i, j = rng.integers(0, len(pop), size=2)
            if rank[i] != rank[j]:
                return pop[i] if rank[i] < rank[j] else pop[j]
            return pop[i] if crowd[i] >= crowd[j] else pop[j]

        children: list[Individual] = []
        seen = {p.key() for p in pop}
        while len(children) < cfg.pop_size:
            p1, p2 = tournament(), tournament()
            if rng.random() < cfg.p_crossover:
                cx = rng.random(n_genes) < 0.5
                mask = np.where(cx, p1.mask, p2.mask)
                ta = p1.trunc_a if rng.random() < 0.5 else p2.trunc_a
                tb = p1.trunc_b if rng.random() < 0.5 else p2.trunc_b
            else:
                mask, ta, tb = p1.mask.copy(), p1.trunc_a, p1.trunc_b
            flip = rng.random(n_genes) < cfg.p_mut_gate
            mask = mask ^ flip
            if rng.random() < cfg.p_mut_trunc:
                ta = int(np.clip(ta + rng.integers(-1, 2), 0, cfg.max_trunc))
            if rng.random() < cfg.p_mut_trunc:
                tb = int(np.clip(tb + rng.integers(-1, 2), 0, cfg.max_trunc))
            child = make(mask, ta, tb)
            if child.nmed <= cfg.nmed_cap and child.key() not in seen:
                seen.add(child.key())
                children.append(child)
            elif child.nmed > cfg.nmed_cap:
                # still allow occasionally to keep diversity pressure low
                pass
            if len(seen) > 10 * cfg.pop_size and len(children) == 0:
                children.append(child)  # safety: avoid infinite loop

        merged = pop + children
        objs = np.array([[p.area, p.nmed] for p in merged])
        fronts = _nondominated_sort(objs)
        next_pop: list[Individual] = []
        for fr in fronts:
            if len(next_pop) + len(fr) <= cfg.pop_size:
                next_pop.extend(merged[i] for i in fr)
            else:
                cd = _crowding(objs, fr)
                order = fr[np.argsort(-cd)]
                for i in order[: cfg.pop_size - len(next_pop)]:
                    next_pop.append(merged[i])
                break
        pop = next_pop

    objs = np.array([[p.area, p.nmed] for p in pop])
    front = _nondominated_sort(objs)[0]
    result = sorted((pop[i] for i in front), key=lambda p: p.area)
    return result


def front_to_multipliers(front: list[Individual]) -> list[multmod.ApproxMultiplier]:
    out = []
    seen: set[tuple] = set()
    for k, ind in enumerate(front):
        okey = (round(ind.area, 3), round(ind.nmed, 7))
        if okey in seen:  # duplicate objective point -> keep one
            continue
        seen.add(okey)
        m = multmod.pruned(ind.mask, name=f"nsga{k}_a{ind.area:.0f}",
                           trunc_a=ind.trunc_a, trunc_b=ind.trunc_b)
        out.append(m)
    return out


# ---------------------------------------------------------------------------
# Cached default front (resolves the "pareto:<band>" multiplier names)
# ---------------------------------------------------------------------------

def cache_dir() -> pathlib.Path:
    """$REPRO_CACHE_DIR, else `.cache` at the repository root."""
    return pathlib.Path(os.environ.get(
        "REPRO_CACHE_DIR",
        pathlib.Path(__file__).resolve().parents[3] / ".cache"))


@functools.lru_cache(maxsize=1)
def default_front(pop_size: int = 56, generations: int = 44, seed: int = 0
                  ) -> list[multmod.ApproxMultiplier]:
    """NSGA-II front with disk cache (genome-level, re-evaluated on load)."""
    cdir = cache_dir()
    cdir.mkdir(parents=True, exist_ok=True)
    cache = cdir / (f"torch_nsga_front_p{pop_size}_g{generations}"
                    f"_s{seed}.json")
    nl = nlmod.bw8()
    n_genes = len(nl.prunable_gates())
    if cache.exists():
        try:
            data = json.loads(cache.read_text())
            if data.get("n_genes") == n_genes:
                front = [
                    Individual(
                        np.array(e["mask"], dtype=bool), e["ta"], e["tb"],
                        e["area"], e["nmed"])
                    for e in data["front"]
                ]
                return front_to_multipliers(front)
        except (json.JSONDecodeError, KeyError):
            pass
    front = nsga2(NSGAConfig(pop_size=pop_size, generations=generations,
                             seed=seed))
    cache.write_text(json.dumps({
        "n_genes": n_genes,
        "front": [
            {"mask": ind.mask.astype(int).tolist(), "ta": ind.trunc_a,
             "tb": ind.trunc_b, "area": ind.area, "nmed": ind.nmed}
            for ind in front
        ],
    }))
    return front_to_multipliers(front)


def pick_by_nmed(mults: list[multmod.ApproxMultiplier], max_nmed: float
                 ) -> multmod.ApproxMultiplier:
    """Smallest-area multiplier with NMED <= max_nmed."""
    ok = [m for m in mults if m.stats.nmed <= max_nmed]
    if not ok:
        return multmod.exact_multiplier()
    return min(ok, key=lambda m: m.area_nand2eq)
