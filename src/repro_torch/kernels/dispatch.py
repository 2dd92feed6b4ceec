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

The kernel plan is static: the skinny kernel for m <= 32 at any rank;
above that the tiled kernels, the plane-0 kernel for exact/trunc specs
and the fused low-rank kernel for low-rank ones (plan path "fused").  Path
"stacked" — the fused kernel's parity twin over pre-mapped operand stacks
— is a valid plan that `choose_gemm_path` never returns: a caller asks for
it with `GemmPlan("stacked", ...)` or `ops.approx_qgemm(fused=False)`.
(The JAX package reaches it through its autotune cache; that cache and its
roofline plan are not ported yet.)
"""

from __future__ import annotations

import dataclasses
import os

import torch

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


@dataclasses.dataclass(frozen=True)
class GemmPlan:
    """Execution plan for one approximate GEMM.

    `path` is "fused" (the kernels on raw operands: the plane-0 kernel
    or the fused low-rank kernel, or the skinny kernel when `skinny`),
    "stacked" (the stacked kernel on pre-mapped planes) or "xla" (the
    plain PyTorch path of approx/gemm.py); `bm/bk/bn` are the padding
    multiples (bm is the true row count on the skinny kernel)."""
    path: str
    bm: int
    bk: int
    bn: int
    skinny: bool = False

    @property
    def use_pallas(self) -> bool:
        return self.path != "xla"


def choose_gemm_path(policy: str | None, *, m: int, k: int, n: int,
                     device: torch.device | str = "cuda",
                     rank: int = 0) -> GemmPlan:
    """The GEMM dispatch: the kernels (skinny for m <= SKINNY_MAX_M, the
    tiled kernel of the spec's mode otherwise) or the plain path, per the
    policy and the operands' device.  `rank` is the spec's low-rank rank
    (0 for exact/trunc)."""
    from repro_torch.kernels import approx_qgemm as qk

    bm, bk, bn = qk.choose_blocks(m, k, n,
                                  kernel="fused" if rank else "plane0")
    if not use_kernels(policy, torch.device(device)):
        return GemmPlan("xla", bm, bk, bn)
    if m <= qk.SKINNY_MAX_M:
        sbk, sbn = qk.choose_skinny_blocks(k, n)
        return GemmPlan("fused", m, sbk, sbn, skinny=True)
    return GemmPlan("fused", bm, bk, bn)


def use_pallas_attention(policy: str | None,
                         device: torch.device | str) -> bool:
    """Flash attention: the kernel vs the plain chunked online-softmax
    forward, by the same rule as the GEMMs."""
    return use_kernels(policy, torch.device(device))
