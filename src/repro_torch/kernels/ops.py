"""Public wrappers around the kernels: padding to the kernels' multiples,
cropping, and the routing of each spec to its kernel.

Each wrapper takes the kernel for a CUDA tensor and the kernel's plain
PyTorch version for a CPU tensor (the CPU counterpart of the JAX package
running its Pallas kernels in interpret mode).  A CUDA tensor never falls
back: what no ported kernel computes raises.

The approximate GEMM runs FUSED by default: raw quantized operands go
straight into the kernel, which applies the truncation mask and the
per-rank table maps itself.  The stacked path — `build_stacks` pre-maps
the operands in PyTorch into (P, M, K) / (P, K, N) intermediates — is kept
behind `fused=False` as the fused kernel's parity twin.
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


def build_stacks(a_q: torch.Tensor, b_q: torch.Tensor,
                 spec: gemm_mod.MultSpec
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Build (P, M, K) / (P, K, N) int8 operand stacks + (P, 1) f32 scales.

    Plane 0 carries the raw (or truncation-masked) operands with scale +1;
    planes 1..R carry the table-mapped correction operands with scale -s_r.
    """
    one = torch.ones((1,), dtype=torch.float32, device=a_q.device)
    if spec.mode == "trunc":
        a0 = gemm_mod._trunc_mask(a_q, spec.trunc_a)
        b0 = gemm_mod._trunc_mask(b_q, spec.trunc_b)
        return a0[None], b0[None], one[:, None]
    planes_a, planes_b = [a_q], [b_q]
    for r in range(spec.rank):
        planes_a.append(gemm_mod._table_map(spec.fu_q[r], a_q))
        planes_b.append(gemm_mod._table_map(spec.fv_q[r], b_q))
    scales = torch.cat([one, -spec.s_r[:spec.rank].to(a_q.device)])
    return torch.stack(planes_a), torch.stack(planes_b), scales[:, None]


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
    """(R+1,) f32 flush scales: 1 for plane 0, -s_r for the corrections.
    The kernel routes call it at rank > 0 only: at rank 0 the one plane's
    scale is 1 and the kernels take none."""
    one = torch.ones((1,), dtype=torch.float32, device=device)
    if not rank:
        return one
    return torch.cat([one, -spec.s_r.to(device)])


def approx_qgemm(a_q: torch.Tensor, b_q: torch.Tensor,
                 spec: gemm_mod.MultSpec, *, bm: int | None = None,
                 bk: int | None = None, bn: int | None = None,
                 fused: bool = True, skinny: bool = False,
                 b_t: torch.Tensor | None = None,
                 splits: int | None = None) -> torch.Tensor:
    """int8 (m, k) x int8 (k, n) -> f32 (m, n) through the kernels.

    `fused=True` (default) hands the raw operands to the kernels, which
    map and mask them themselves: the plane-0 kernel for exact/trunc
    specs, the fused low-rank kernel for low-rank ones, and with
    `skinny=True` the skinny kernel for a decode-shaped GEMM
    (m <= SKINNY_MAX_M, M unpadded) at any rank.  All three take the
    weight K-major: `b_t` (n, k), equal to `b_q.T`, when the caller keeps
    one (a prepared weight), else `b_q` is transposed here.
    `fused=False` runs the stacked twin on `build_stacks`' pre-mapped
    planes.  A plan's knobs pass through: `splits` (K splits of the
    plane-0 and skinny kernels) and `bn` (the low-rank kernels' tile
    width, to which N pads); None keeps each kernel's own choice."""
    m, k = a_q.shape
    k2, n = b_q.shape
    assert k == k2, (a_q.shape, b_q.shape)
    trunc_a, trunc_b, rank = _spec_kernel_args(spec)
    bt = b_q.T if b_t is None else b_t
    assert bt.shape == (n, k), (bt.shape, n, k)
    if fused and skinny:
        assert m <= qk.SKINNY_MAX_M, (m, qk.SKINNY_MAX_M)
        bk, bn = qk.choose_skinny_blocks(k, n, bk, bn)
        ap = _aligned(_pad_to(a_q, 1, bk))
        btp = _aligned(_pad_to(_pad_to(bt, 0, bn), 1, bk))
        fu, fv = _tables(spec, rank, a_q.device)
        out = qgemm.approx_qgemm_skinny(
            ap, btp, fu, fv,
            plane_scales(spec, rank, a_q.device) if rank else None,
            trunc_a=trunc_a, trunc_b=trunc_b, k_valid=k, splits=splits)
        return out[:, :n]
    if not fused:
        bm, bk, bn = qk.choose_blocks(m, k, n, bm, bk, bn, kernel="stacked")
        a_s, b_s, s = build_stacks(a_q, b_q, spec)
        a_s = _aligned(_pad_to(_pad_to(a_s, 1, bm), 2, bk))
        b_s = _aligned(_pad_to(_pad_to(b_s, 1, bk), 2, bn))
        return qgemm.approx_qgemm_stacked(a_s, b_s, s, bn=bn)[:m, :n]
    kernel = "fused" if rank else "plane0"
    bm, bk, bn = qk.choose_blocks(m, k, n, bm, bk, bn, kernel=kernel)
    ap = _aligned(_pad_to(_pad_to(a_q, 0, bm), 1, bk))
    btp = _aligned(_pad_to(_pad_to(bt, 0, bn), 1, bk))
    if rank:
        fu, fv = _tables(spec, rank, a_q.device)
        out = qgemm.approx_qgemm_fused(
            ap, btp, fu, fv, plane_scales(spec, rank, a_q.device),
            trunc_a=trunc_a, trunc_b=trunc_b, k_valid=k, bn=bn)
    else:
        out = qgemm.approx_qgemm_plane0(ap, btp, trunc_a=trunc_a,
                                        trunc_b=trunc_b, splits=splits)
    return out[:m, :n]


def _tables(spec: gemm_mod.MultSpec, rank: int, device
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The spec's (rank, 256) factor tables on `device` ((0, 256) at rank
    0: the kernels then read no table)."""
    if not rank:
        return spec.fu_q[:0], spec.fv_q[:0]
    return spec.fu_q[:rank].to(device), spec.fv_q[:rank].to(device)


def approx_qgemm_planned(a_q: torch.Tensor, b_q: torch.Tensor,
                         spec: gemm_mod.MultSpec, plan: dispatch.GemmPlan,
                         b_t: torch.Tensor | None = None) -> torch.Tensor:
    """Execute a GEMM per a `dispatch.choose_gemm_path` kernel plan (the
    plain path belongs to approx/gemm.py, which knows prepared weights).
    `b_t` is the weight's K-major copy, for the plane-0, fused and skinny
    kernels."""
    assert plan.path in ("fused", "stacked"), plan
    if plan.path == "stacked":
        return approx_qgemm(a_q, b_q, spec, bm=plan.bm, bk=plan.bk,
                            bn=plan.bn, fused=False)
    if plan.skinny:
        return approx_qgemm(a_q, b_q, spec, bk=plan.bk, bn=plan.bn,
                            skinny=True, b_t=b_t, splits=plan.splits)
    return approx_qgemm(a_q, b_q, spec, bm=plan.bm, bk=plan.bk, bn=plan.bn,
                        b_t=b_t, splits=plan.splits)


def approx_qgemm_tp(a_q: torch.Tensor, b_local: torch.Tensor,
                    spec: gemm_mod.MultSpec, mesh, *,
                    b_t: torch.Tensor | None = None, gather: bool = True,
                    axis: str = "model") -> torch.Tensor:
    """Column-parallel tensor-parallel GEMM.  Activations are
    replicated; `b_local` is this rank's (k, n/tp) column block of the
    weight (`mesh.shard_cols`), `b_t` its K-major copy.  Each rank
    contracts the full K against its block under its plan for the
    shard-local shape, so there is no cross-rank reduction and the result
    is bit-identical to one device.  `gather` all-gathers the (m, n)
    result over the model group; else the rank's (m, n/tp) block comes
    back.  The model's layers reach the same path through
    `approx.gemm._approx_forward`."""
    out = approx_qgemm_replicated(a_q, b_local, spec, b_t=b_t)
    return mesh.all_gather(out, axis) if gather else out


def approx_qgemm_replicated(a_q: torch.Tensor, b_q: torch.Tensor,
                            spec: gemm_mod.MultSpec, *,
                            b_t: torch.Tensor | None = None
                            ) -> torch.Tensor:
    """The replicated branch of a multi-rank mesh, and one device's GEMM:
    an output dim that does not divide the model axis stays whole, and
    every rank runs the whole GEMM under its plan (the kernel, else the
    plain path)."""
    plan = gemm_mod._gemm_plan(spec, a_q.shape[0], a_q.shape[1],
                               b_q.shape[1], a_q.device)
    if plan.use_pallas:
        return approx_qgemm_planned(a_q, b_q, spec, plan, b_t)
    return gemm_mod.approx_qgemm(a_q, b_q, spec)


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
