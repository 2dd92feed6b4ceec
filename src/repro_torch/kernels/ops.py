"""Public wrappers around the kernels: padding to the kernels' multiples,
cropping, and the routing of each spec to its kernel.

Each wrapper takes the kernel for a CUDA tensor and the kernel's plain
PyTorch version for a CPU tensor (the CPU counterpart of the JAX package
running its Pallas kernels in interpret mode).  A CUDA tensor never falls
back: what no ported kernel computes raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.approx import gemm as gemm_mod
from repro_torch.kernels import approx_qgemm as qk
from repro_torch.kernels import dispatch
from repro_torch.kernels import flash_attention as fk
from repro_torch.kernels import qgemm
from repro_torch.kernels import quantize as qz


def _pad_to(x: torch.Tensor, axis: int, mult: int) -> torch.Tensor:
    size = x.shape[axis]
    pad = (-size) % mult
    if pad == 0:
        return x
    widths = [0, 0] * x.ndim
    widths[2 * (x.ndim - 1 - axis) + 1] = pad
    return F.pad(x, widths)


def _spec_kernel_args(spec: gemm_mod.MultSpec) -> tuple[int, int, int]:
    """(trunc_a, trunc_b, rank) as the kernels consume them."""
    trunc_a = spec.trunc_a if spec.mode == "trunc" else 0
    trunc_b = spec.trunc_b if spec.mode == "trunc" else 0
    rank = spec.rank if spec.mode == "lowrank" else 0
    return trunc_a, trunc_b, rank


def _aligned(x: torch.Tensor) -> torch.Tensor:
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def plane_scales(spec: gemm_mod.MultSpec, rank: int,
                 device: torch.device) -> torch.Tensor:
    """(R+1,) f32 flush scales: 1 for plane 0, -s_r for the corrections."""
    one = torch.ones((1,), dtype=torch.float32, device=device)
    if not rank:
        return one
    return torch.cat([one, -spec.s_r.to(device)])


def approx_qgemm(a_q: torch.Tensor, b_q: torch.Tensor,
                 spec: gemm_mod.MultSpec, *, bm: int | None = None,
                 bk: int | None = None, bn: int | None = None,
                 skinny: bool = False) -> torch.Tensor:
    """int8 (m, k) x int8 (k, n) -> f32 (m, n) through the kernels.

    `skinny=True` routes a decode-shaped GEMM (m <= SKINNY_MAX_M) to the
    skinny kernel, M unpadded; otherwise exact/trunc specs take the tiled
    plane-0 kernel.  Low-rank specs at m > SKINNY_MAX_M need the fused
    low-rank kernel, which is not ported yet: on CUDA they raise."""
    m, k = a_q.shape
    k2, n = b_q.shape
    assert k == k2, (a_q.shape, b_q.shape)
    trunc_a, trunc_b, rank = _spec_kernel_args(spec)
    if skinny:
        assert m <= qk.SKINNY_MAX_M, (m, qk.SKINNY_MAX_M)
        bk, bn = qk.choose_skinny_blocks(k, n, bk, bn)
        ap = _aligned(_pad_to(a_q, 1, bk))
        bp = _aligned(_pad_to(_pad_to(b_q, 0, bk), 1, bn))
        fu, fv = spec.fu_q, spec.fv_q
        if rank:
            fu, fv = fu[:rank].to(a_q.device), fv[:rank].to(a_q.device)
        out = qgemm.approx_qgemm_skinny(
            ap, bp, fu, fv, plane_scales(spec, rank, a_q.device),
            trunc_a=trunc_a, trunc_b=trunc_b, k_valid=k)
        return out[:, :n]
    bm, bk, bn = qk.choose_blocks(m, k, n, bm, bk, bn)
    ap = _aligned(_pad_to(_pad_to(a_q, 0, bm), 1, bk))
    bp = _aligned(_pad_to(_pad_to(b_q, 0, bk), 1, bn))
    if rank:
        if a_q.device.type != "cpu":
            raise NotImplementedError("approx_qgemm_fused not ported yet")
        out = qgemm.planes_plain(
            ap, bp, spec.fu_q, spec.fv_q, plane_scales(spec, rank, "cpu"),
            k_valid=k)
    else:
        out = qgemm.approx_qgemm_plane0(ap, bp, trunc_a=trunc_a,
                                        trunc_b=trunc_b)
    return out[:m, :n]


def approx_qgemm_planned(a_q: torch.Tensor, b_q: torch.Tensor,
                         spec: gemm_mod.MultSpec,
                         plan: dispatch.GemmPlan) -> torch.Tensor:
    """Execute a GEMM per a `dispatch.choose_gemm_path` kernel plan (the
    plain path belongs to approx/gemm.py, which knows prepared weights)."""
    assert plan.path == "fused", plan
    if plan.skinny:
        return approx_qgemm(a_q, b_q, spec, bk=plan.bk, bn=plan.bn,
                            skinny=True)
    return approx_qgemm(a_q, b_q, spec, bm=plan.bm, bk=plan.bk, bn=plan.bn)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, bq: int | None = None,
                    bkv: int | None = None) -> torch.Tensor:
    """q (bh, sq, d), k/v (bh, skv, d) -> (bh, sq, d)."""
    return fk.flash_attention(q, k, v, causal=causal, bq=bq, bkv=bkv)


def quantize_rows(x: torch.Tensor, *, trunc: int = 0
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(M, K) f32 -> int8 rows + (M, 1) scales via the fused kernel, the
    trunc mask folded into the same pass.  The kernel takes any M, so no
    row padding is needed."""
    return qz.quantize_rows(x, trunc=trunc)
