"""Kernel-dispatch policy: the hand-written CUDA kernels vs the plain
PyTorch versions.

The three policy names of the JAX package are kept, with their meaning
carried over to this port:

  "pallas" — the hand-written CUDA kernels (csrc/).  A CPU tensor, which
             no kernel accepts, takes the kernel's plain version inside
             the wrapper, the way the JAX package runs its kernels in
             interpret mode off-TPU;
  "xla"    — the plain PyTorch versions, on any device;
  "auto"   — the kernels for a CUDA tensor, the plain versions for a CPU
             tensor.

The policy rides on `MultSpec.policy`, is settable per model through
`ModelConfig.kernel_policy`, per run through `--kernel-policy`, and
process-wide through `$REPRO_KERNEL_POLICY`.

The GEMM plan resolves in two steps:

  1. a MEASURED winner from the tuning cache (`kernels/autotune.py`) for
     this card, shape bucket, mode and rank, re-validated against the
     shape, wins outright under "auto", splits and tiles included: path
     "fused" (the skinny kernel for m <= 32 at any rank; above it the
     plane-0 kernel for exact/trunc specs and the fused low-rank kernel
     for low-rank ones) or "stacked" (the fused kernel's twin over
     pre-mapped operand stacks); under "pallas" a tuned fused entry is
     honoured and any other ignored;
  2. else the static plan: the fused path at the kernels' own tiles and
     splits for the card ("pallas", or "auto" on a CUDA tensor); the plain
     path for "auto" on a CPU tensor.

The JAX package asks its roofline model between the two steps; this port
does not: only a measurement moves a GEMM off the static plan.  A CUDA
GEMM never takes the plain path unless the policy pins "xla": the tuner
times it as a yardstick and never elects it.  Plans are memoized per
(policy, shape, mode, rank, device) for the life of the process, since
the port dispatches eagerly on every GEMM; the memo is cleared when the
cache path changes or the process saves a tuning.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from repro_torch.kernels import approx_qgemm as qk
from repro_torch.kernels import autotune

POLICIES = ("auto", "pallas", "xla")

_ENV_VAR = "REPRO_KERNEL_POLICY"


def default_policy() -> str:
    """Process-wide default: $REPRO_KERNEL_POLICY or "auto"."""
    p = os.environ.get(_ENV_VAR, "auto").strip().lower()
    return p if p in POLICIES else "auto"


def resolve(policy: str | None) -> str:
    """Normalize a user-supplied policy; None/"" and "auto" resolve
    through the process default."""
    p = "auto" if policy in (None, "") else str(policy).lower()
    if p not in POLICIES:
        raise ValueError(f"unknown kernel policy {policy!r}; "
                         f"expected one of {POLICIES}")
    return default_policy() if p == "auto" else p


def use_kernels(policy: str | None, device: torch.device) -> bool:
    """Whether work on `device` goes through the kernel wrappers."""
    p = resolve(policy)
    if p == "xla":
        return False
    if p == "pallas":
        return True
    return torch.device(device).type == "cuda"


def tp_degree(mesh) -> int:
    """Model-axis size of a mesh (1 when absent / no mesh): the tensor-
    parallel fan-out a GEMM's output dimension is split across."""
    if mesh is None:
        return 1
    return int(mesh.shape.get("model", 1))


def tp_split(n: int, tp: int) -> int:
    """Shard-local output dimension under `tp`-way column parallelism
    (the whole dim when it does not divide: that GEMM stays unsplit).
    Plans, the memo and tuning buckets key on the shard-local
    (m, k, tp_split(n, tp)), since that is the GEMM each rank runs."""
    return n // tp if tp > 1 and n % tp == 0 else n


@dataclasses.dataclass(frozen=True)
class GemmPlan:
    """Execution plan for one approximate GEMM.

    `path` is "fused" (the kernels on raw operands: the plane-0 kernel
    or the fused low-rank kernel, or the skinny kernel when `skinny`),
    "stacked" (the stacked kernel on pre-mapped planes) or "xla" (the
    plain PyTorch path of approx/gemm.py); `bm/bk/bn` are the padding
    multiples (bm is the true row count on the skinny kernel; bn the
    low-rank kernels' tile width); `splits` the plane-0 or skinny
    kernel's split of K (None: the kernel's own rule for the card).
    `source` records why: "policy" (pinned by "pallas" or "xla"),
    "tuned" (a tuning-cache hit), "default" (no measurement: the static
    plan under "auto")."""
    path: str
    bm: int
    bk: int
    bn: int
    skinny: bool = False
    splits: int | None = None
    source: str = "default"

    @property
    def use_pallas(self) -> bool:
        return self.path != "xla"

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


#: (policy, m, k, n, mode, rank, device) -> GemmPlan, under `_plans_stamp`
_plans: dict = {}
_plans_stamp: tuple | None = None
#: plans resolved (memo misses) in this process: one-time work, which a
#: warm step does none of (`repro_torch.analysis.retrace`)
plan_misses = 0


def choose_gemm_path(policy: str | None, *, m: int, k: int, n: int,
                     device: torch.device | str = "cuda",
                     mode: str = "exact", rank: int = 0) -> GemmPlan:
    """The GEMM dispatch (module docstring): the kernels, with a tuned or
    static plan, or the plain path, per the policy and the
    operands' device.  `mode` is the spec's mode and `rank` its low-rank
    rank (0 for exact/trunc)."""
    global _plans_stamp, plan_misses
    p = resolve(policy)
    dev = torch.device(device)
    stamp = (autotune.cache_path(), autotune.generation)
    if stamp != _plans_stamp:
        _plans.clear()
        _plans_stamp = stamp
    key = (p, m, k, n, mode, rank, dev)
    plan = _plans.get(key)
    if plan is None:
        plan_misses += 1
        plan = _plans[key] = _choose(p, m, k, n, dev, mode, rank)
    return plan


def _choose(p: str, m: int, k: int, n: int, dev: torch.device, mode: str,
            rank: int) -> GemmPlan:
    bm, bk, bn = qk.choose_blocks(m, k, n,
                                  kernel="fused" if rank else "plane0")
    if p == "xla":
        return GemmPlan("xla", bm, bk, bn, source="policy")
    if not use_kernels(p, dev):
        return GemmPlan("xla", bm, bk, bn)
    source = "policy" if p == "pallas" else "default"
    if m <= qk.SKINNY_MAX_M:
        sbk, sbn = qk.choose_skinny_blocks(k, n)
        static = GemmPlan("fused", m, sbk, sbn, skinny=True, source=source)
    else:
        static = GemmPlan("fused", bm, bk, bn, source=source)
    if dev.type != "cuda":
        return static
    tuned = _tuned_plan(m, k, n, mode, rank, dev)
    if tuned is None or (p == "pallas" and tuned.path != "fused"):
        return static
    return tuned


def _tuned_plan(m: int, k: int, n: int, mode: str, rank: int,
                dev: torch.device) -> GemmPlan | None:
    """A tuning-cache hit for this card -> GemmPlan, re-validated against
    the shape: an entry whose split count or tile width this shape cannot
    take (another shape of its bucket tuned it) is ignored, not trusted."""
    from repro_torch.kernels import qgemm

    if not autotune.entries():
        return None
    hit = autotune.lookup(m, k, n, mode, rank,
                          device_key=autotune.card_of(dev).key)
    if hit is None:
        return None
    skinny = m <= qk.SKINNY_MAX_M
    try:
        if hit.path == "fused" and hit.skinny != skinny:
            return None
        if hit.path == "fused" and skinny:
            sbk, sbn = qk.choose_skinny_blocks(k, n)
            qgemm.skinny_gran(-(-k // sbk) * sbk, hit.splits)
            return GemmPlan("fused", m, sbk, sbn, skinny=True,
                            splits=hit.splits, source="tuned")
        if hit.path == "fused" and not rank:
            tm, tk, tn = qk.PLANE0_TILE
            qgemm.plane0_split_plan(k, hit.splits)
            return GemmPlan("fused", tm, tk, tn, splits=hit.splits,
                            source="tuned")
    except (TypeError, ValueError):
        return None
    if hit.bn not in (qk.FUSED_TILE_NARROW[2], qk.FUSED_TILE[2]):
        return None
    tm, tk = qk.FUSED_TILE[:2]
    return GemmPlan(hit.path, tm, tk, hit.bn, source="tuned")


def use_pallas_attention(policy: str | None,
                         device: torch.device | str) -> bool:
    """Flash attention: the kernel vs the plain chunked online-softmax
    forward, by the same rule as the GEMMs."""
    return use_kernels(policy, torch.device(device))
