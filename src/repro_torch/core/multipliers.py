"""Approximate-multiplier abstraction: netlist config -> LUT + area + errors.

An `ApproxMultiplier` bundles everything downstream layers need:
  * its 256x256 product LUT (the ApproxTrain-style behavioral model),
  * its silicon area (live-gate NAND2-equivalents -> um^2 per node),
  * error statistics, and
  * the low-rank error factorization used by the approximate GEMM path.

The paper's two approximation knobs map to:
  * precision scaling  -> `truncated(ta, tb)`
  * gate-level pruning -> `pruned(mask)` over the prunable-gate list, with
    signal-probability-directed constants and dead-gate elimination.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from . import lut as lutmod
from . import netlist as nlmod


@dataclasses.dataclass(frozen=True)
class ApproxMultiplier:
    name: str
    lut: np.ndarray                      # (256,256) int32, [a&0xFF, b&0xFF]
    area_nand2eq: float
    stats: lutmod.ErrorStats
    trunc_a: int = 0
    trunc_b: int = 0
    pruned_gates: tuple[int, ...] = ()   # gate ids pruned (for provenance)

    def area_um2(self, node_nm: int) -> float:
        return self.area_nand2eq * nlmod.NAND2_UM2[node_nm]

    @property
    def is_exact(self) -> bool:
        return self.stats.wce == 0

    @functools.cached_property
    def lowrank(self) -> lutmod.LowRankError:
        return lutmod.choose_rank(self.lut, tol_nmed=1e-4, max_rank=8)

    def area_savings_vs_exact(self) -> float:
        return 1.0 - self.area_nand2eq / exact_multiplier().area_nand2eq


def _mk(name: str, pruned: dict[int, int], trunc_a: int = 0, trunc_b: int = 0,
        pruned_gates: tuple[int, ...] = ()) -> ApproxMultiplier:
    nl = nlmod.bw8()
    full = nlmod.constant_propagate(nl, pruned) if pruned else {}
    lut = nlmod.netlist_lut(nl, full)
    return ApproxMultiplier(
        name=name,
        lut=lut,
        area_nand2eq=nl.area_nand2eq(full),
        stats=lutmod.error_stats(lut),
        trunc_a=trunc_a, trunc_b=trunc_b, pruned_gates=pruned_gates,
    )


@functools.lru_cache(maxsize=1)
def exact_multiplier() -> ApproxMultiplier:
    m = _mk("exact", {})
    assert m.stats.wce == 0, "exact netlist must be exact"
    return m


@functools.lru_cache(maxsize=64)
def truncated(trunc_a: int, trunc_b: int) -> ApproxMultiplier:
    """Precision-scaled multiplier: k LSBs of each operand forced to zero."""
    nl = nlmod.bw8()
    pr = nlmod.truncation_pruning(nl, trunc_a, trunc_b)
    return _mk(f"trunc{trunc_a}x{trunc_b}", pr, trunc_a, trunc_b)


def pruned(mask: np.ndarray, name: str = "", trunc_a: int = 0, trunc_b: int = 0
           ) -> ApproxMultiplier:
    """Gate-level pruning: mask is a bool vector over `prunable_gates()`.

    Pruned gates output their most-probable constant (signal probability,
    as in [5]); optional operand truncation composes on top.
    """
    nl = nlmod.bw8()
    prunable = nl.prunable_gates()
    probs = _signal_probs()
    assert mask.shape == (len(prunable),)
    pr: dict[int, int] = {}
    chosen: list[int] = []
    for k, bit in enumerate(mask):
        if bit:
            gid = prunable[k]
            pr[gid] = int(probs[gid] >= 0.5)
            chosen.append(gid)
    pr.update(nlmod.truncation_pruning(nl, trunc_a, trunc_b))
    return _mk(name or f"pruned[{len(chosen)}g,t{trunc_a}{trunc_b}]", pr,
               trunc_a, trunc_b, tuple(chosen))


@functools.lru_cache(maxsize=1)
def _signal_probs() -> np.ndarray:
    return nlmod.signal_probabilities(nlmod.bw8())


# ---------------------------------------------------------------------------
# Library: the named multipliers the rest of the framework refers to.
# The "appx_*" entries come from the NSGA-II Pareto front (see pareto.py /
# codesign.py); the static entries below are always available and cheap.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def static_library() -> dict[str, ApproxMultiplier]:
    lib = {"exact": exact_multiplier()}
    for t in (1, 2, 3, 4):
        m = truncated(t, t)
        lib[m.name] = m
    for ta, tb in ((2, 0), (0, 2), (3, 1)):
        m = truncated(ta, tb)
        lib[m.name] = m
    return lib


def get_multiplier(name: str) -> ApproxMultiplier:
    lib = static_library()
    if name in lib:
        return lib[name]
    # Lazily extend with Pareto-searched multipliers by convention
    # "pareto:<nmed_band>" e.g. "pareto:0.005".
    if name.startswith("pareto:"):
        from . import pareto as paretomod
        band = float(name.split(":", 1)[1])
        front = paretomod.default_front()
        return paretomod.pick_by_nmed(front, band)
    raise KeyError(f"unknown multiplier {name!r}; have {sorted(lib)}")
