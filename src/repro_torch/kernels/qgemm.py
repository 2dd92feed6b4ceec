"""Approximate int8 GEMM kernels: wrappers of the CUDA kernels in
csrc/qgemm.cu and their plain PyTorch versions.

`approx_qgemm_plane0` — exact / truncation multipliers, any M: one masked
int8 product accumulated in int32, f32 out.

`approx_qgemm_fused` — low-rank multipliers, any M: plane 0 plus R
table-mapped correction planes (tables (R, 256) int8 indexed by
`q & 0xFF`, mapped A zeroed past `k_valid`), each plane an int32 sum,
flushed in plane order as `acc = acc + s_r * acc_r` in f32.

`approx_qgemm_skinny` — the same planes for decode-shaped GEMMs
(m <= SKINNY_MAX_M).

`approx_qgemm_stacked` — the fused kernel's parity twin: a plain int8
GEMM per plane over operand stacks that `ops.build_stacks` pre-maps, with
the same flush.

The wrappers take operands already padded to the kernels' multiples
(ops.py pads and crops).  A CUDA tensor goes to the kernel, a CPU tensor to
the plain version.  The integer planes are exact either way, and the flush
rounds each product and each sum separately on both sides, so the kernels
and the plain versions agree bit for bit.
"""

from __future__ import annotations

import torch

from repro_torch.approx.gemm import _table_map, _trunc_mask, qgemm_int32
from repro_torch.kernels import approx_qgemm as qk
from repro_torch.kernels import build

#: The card's SM count: the skinny kernel splits K until the grid covers
#: about two blocks per SM.
_TARGET_BLOCKS = 2 * 132


def planes_plain(a_q: torch.Tensor, b_q: torch.Tensor, fu_q: torch.Tensor,
                 fv_q: torch.Tensor, scales: torch.Tensor, *,
                 trunc_a: int = 0, trunc_b: int = 0,
                 k_valid: int | None = None) -> torch.Tensor:
    """The plane semantic every approximate GEMM kernel computes:
    a_q (M, K) x b_q (K, N) int8, fu_q/fv_q (R, 256) int8 tables, scales
    (R+1,) f32 with scales[0] = 1 and scales[r] = -s_r -> (M, N) f32."""
    k = a_q.shape[1]
    k_valid = k if k_valid is None else k_valid
    accs = [qgemm_int32(_trunc_mask(a_q, trunc_a),
                        _trunc_mask(b_q, trunc_b))]
    if fu_q.shape[0]:
        in_k = (torch.arange(k, device=a_q.device) < k_valid)[None, :]
        for r in range(fu_q.shape[0]):
            ua = torch.where(in_k, _table_map(fu_q[r], a_q),
                             torch.zeros((), dtype=torch.int8,
                                         device=a_q.device))
            accs.append(qgemm_int32(ua, _table_map(fv_q[r], b_q)))
    out = torch.zeros(accs[0].shape, dtype=torch.float32,
                      device=a_q.device)
    for r, acc in enumerate(accs):
        out = out + scales[r] * acc.to(torch.float32)
    return out


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors and the "
                         f"plain version CPU tensors, not {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: operands on {dev} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: operands must be 16-byte aligned")


def approx_qgemm_plane0_plain(a_q: torch.Tensor, b_q: torch.Tensor, *,
                              trunc_a: int = 0, trunc_b: int = 0
                              ) -> torch.Tensor:
    return qgemm_int32(_trunc_mask(a_q, trunc_a),
                       _trunc_mask(b_q, trunc_b)).to(torch.float32)


def approx_qgemm_plane0(a_q: torch.Tensor, b_q: torch.Tensor, *,
                        trunc_a: int = 0, trunc_b: int = 0) -> torch.Tensor:
    """a_q (M, K) x b_q (K, N) int8 -> f32 (M, N), truncation masks in the
    kernel.  On CUDA: (M, K, N) multiples of `qk.PLANE0_TILE`."""
    if a_q.device.type == "cpu":
        return approx_qgemm_plane0_plain(a_q, b_q, trunc_a=trunc_a,
                                         trunc_b=trunc_b)
    m, k = a_q.shape
    k2, n = b_q.shape
    if a_q.dtype != torch.int8 or b_q.dtype != torch.int8 or k != k2:
        raise ValueError(f"approx_qgemm_plane0: bad operands {a_q.dtype} "
                         f"{tuple(a_q.shape)} x {b_q.dtype} "
                         f"{tuple(b_q.shape)}")
    tm, tk, tn = qk.PLANE0_TILE
    if m % tm or k % tk or n % tn:
        raise ValueError(f"approx_qgemm_plane0: ({m}, {k}, {n}) is not "
                         f"padded to {qk.PLANE0_TILE} multiples")
    _check_cuda("approx_qgemm_plane0", a_q, b_q)
    out = torch.empty((m, n), dtype=torch.float32, device=a_q.device)
    lib = build.load()
    err = lib.repro_qgemm_plane0(
        a_q.data_ptr(), b_q.data_ptr(), out.data_ptr(), m, k, n,
        qk.signed_trunc_mask(trunc_a), qk.signed_trunc_mask(trunc_b),
        build.stream_ptr(a_q.device))
    build.check(err, "approx_qgemm_plane0")
    approx_qgemm_plane0.launches += 1
    return out


approx_qgemm_plane0.launches = 0


def skinny_splits(k: int, n: int, planes: int) -> int:
    """K splits that bring the skinny grid to about two blocks per SM."""
    blocks = max(n // 128, 1) * planes
    return max(1, min(-(-_TARGET_BLOCKS // blocks), k // 128))


def approx_qgemm_skinny_plain(a_q, b_q, fu_q, fv_q, scales, *,
                              trunc_a: int = 0, trunc_b: int = 0,
                              k_valid: int) -> torch.Tensor:
    return planes_plain(a_q, b_q, fu_q, fv_q, scales.reshape(-1),
                        trunc_a=trunc_a, trunc_b=trunc_b, k_valid=k_valid)


def approx_qgemm_skinny(a_q: torch.Tensor, b_q: torch.Tensor,
                        fu_q: torch.Tensor, fv_q: torch.Tensor,
                        scales: torch.Tensor, *, trunc_a: int = 0,
                        trunc_b: int = 0, k_valid: int) -> torch.Tensor:
    """a_q (m <= 32, K) x b_q (K, N) int8, fu_q/fv_q (R, 256) int8 tables
    (R may be 0), scales (R+1,) f32 -> (m, N) f32.  On CUDA: (K, N)
    multiples of `qk.SKINNY_TILE`; m is consumed unpadded."""
    if a_q.device.type == "cpu":
        return approx_qgemm_skinny_plain(a_q, b_q, fu_q, fv_q, scales,
                                         trunc_a=trunc_a, trunc_b=trunc_b,
                                         k_valid=k_valid)
    m, k = a_q.shape
    k2, n = b_q.shape
    rank = fu_q.shape[0]
    if a_q.dtype != torch.int8 or b_q.dtype != torch.int8 or k != k2:
        raise ValueError(f"approx_qgemm_skinny: bad operands {a_q.dtype} "
                         f"{tuple(a_q.shape)} x {b_q.dtype} "
                         f"{tuple(b_q.shape)}")
    tk, tn = qk.SKINNY_TILE
    if not 0 < m <= qk.SKINNY_MAX_M or k % tk or n % tn:
        raise ValueError(f"approx_qgemm_skinny: ({m}, {k}, {n}) needs "
                         f"m <= 32 and (K, N) padded to {qk.SKINNY_TILE} "
                         "multiples")
    if not 0 < k_valid <= k:
        raise ValueError(f"approx_qgemm_skinny: k_valid {k_valid} vs {k}")
    scales = scales.reshape(-1).to(torch.float32).contiguous()
    if scales.shape[0] != rank + 1 or fv_q.shape != fu_q.shape:
        raise ValueError("approx_qgemm_skinny: tables/scales mismatch")
    tensors = [a_q, b_q, scales]
    if rank:
        fu_q, fv_q = fu_q.contiguous(), fv_q.contiguous()
        tensors += [fu_q, fv_q]
    _check_cuda("approx_qgemm_skinny", *tensors)
    acc = torch.empty((rank + 1, m, n), dtype=torch.int32,
                      device=a_q.device)
    out = torch.empty((m, n), dtype=torch.float32, device=a_q.device)
    lib = build.load()
    err = lib.repro_qgemm_skinny(
        a_q.data_ptr(), b_q.data_ptr(),
        fu_q.data_ptr() if rank else None, fv_q.data_ptr() if rank else None,
        scales.data_ptr(), acc.data_ptr(), out.data_ptr(), m, k, n, k_valid,
        rank, qk.signed_trunc_mask(trunc_a), qk.signed_trunc_mask(trunc_b),
        skinny_splits(k, n, rank + 1), build.stream_ptr(a_q.device))
    build.check(err, "approx_qgemm_skinny")
    approx_qgemm_skinny.launches += 1
    return out


approx_qgemm_skinny.launches = 0


def _check_tiled(name: str, a_q, b_q, tile, ndim: int) -> tuple:
    """(m, k, n) of int8 operands a (..., M, K) x b (..., K, N), both
    `ndim`-D, padded to `tile` multiples; raises on what the kernel does
    not take."""
    if a_q.ndim != ndim or b_q.ndim != ndim or a_q.dtype != torch.int8 or \
            b_q.dtype != torch.int8 or a_q.shape[:-2] != b_q.shape[:-2] or \
            a_q.shape[-1] != b_q.shape[-2]:
        raise ValueError(f"{name}: bad operands {a_q.dtype} "
                         f"{tuple(a_q.shape)} x {b_q.dtype} "
                         f"{tuple(b_q.shape)}")
    m, k = a_q.shape[-2:]
    n = b_q.shape[-1]
    tm, tk, tn = tile
    if m % tm or k % tk or n % tn or not (m and k and n):
        raise ValueError(f"{name}: ({m}, {k}, {n}) is not padded to "
                         f"{tile} multiples")
    return m, k, n


#: The fused kernel computes the skinny kernel's planes at any M.
approx_qgemm_fused_plain = approx_qgemm_skinny_plain


def approx_qgemm_fused(a_q: torch.Tensor, b_q: torch.Tensor,
                       fu_q: torch.Tensor, fv_q: torch.Tensor,
                       scales: torch.Tensor, *, trunc_a: int = 0,
                       trunc_b: int = 0, k_valid: int) -> torch.Tensor:
    """a_q (M, K) x b_q (K, N) raw int8, fu_q/fv_q (R, 256) int8 tables
    (R <= 8), scales (R+1,) f32 -> (M, N) f32.  `k_valid` is the true K
    before padding.  On CUDA: (M, K, N) multiples of `qk.FUSED_TILE`."""
    if a_q.device.type == "cpu":
        return approx_qgemm_fused_plain(a_q, b_q, fu_q, fv_q, scales,
                                        trunc_a=trunc_a, trunc_b=trunc_b,
                                        k_valid=k_valid)
    name = "approx_qgemm_fused"
    m, k, n = _check_tiled(name, a_q, b_q, qk.FUSED_TILE, 2)
    rank = fu_q.shape[0]
    if not 0 < k_valid <= k:
        raise ValueError(f"{name}: k_valid {k_valid} vs {k}")
    scales = scales.reshape(-1).to(torch.float32).contiguous()
    if rank > qk.MAX_RANK or scales.shape[0] != rank + 1 or \
            fu_q.shape != (rank, 256) or fv_q.shape != fu_q.shape:
        raise ValueError(f"{name}: tables {tuple(fu_q.shape)} / "
                         f"{tuple(fv_q.shape)} and scales "
                         f"{tuple(scales.shape)} do not match a rank <= "
                         f"{qk.MAX_RANK}")
    tensors = [a_q, b_q, scales]
    if rank:
        fu_q, fv_q = fu_q.contiguous(), fv_q.contiguous()
        tensors += [fu_q, fv_q]
    _check_cuda(name, *tensors)
    out = torch.empty((m, n), dtype=torch.float32, device=a_q.device)
    lib = build.load()
    err = lib.repro_qgemm_fused(
        a_q.data_ptr(), b_q.data_ptr(),
        fu_q.data_ptr() if rank else None, fv_q.data_ptr() if rank else None,
        scales.data_ptr(), out.data_ptr(), m, k, n, k_valid, rank,
        qk.signed_trunc_mask(trunc_a), qk.signed_trunc_mask(trunc_b),
        build.stream_ptr(a_q.device))
    build.check(err, name)
    approx_qgemm_fused.launches += 1
    return out


approx_qgemm_fused.launches = 0


def approx_qgemm_stacked_plain(a_stack: torch.Tensor, b_stack: torch.Tensor,
                               scales: torch.Tensor) -> torch.Tensor:
    """sum_p scales[p] * (a_stack[p] . b_stack[p]), each plane an exact
    int32 product, flushed in plane order from 0."""
    scales = scales.reshape(-1)
    out = torch.zeros((a_stack.shape[1], b_stack.shape[2]),
                      dtype=torch.float32, device=a_stack.device)
    for p in range(a_stack.shape[0]):
        out = out + scales[p] * qgemm_int32(a_stack[p], b_stack[p]).to(
            torch.float32)
    return out


def approx_qgemm_stacked(a_stack: torch.Tensor, b_stack: torch.Tensor,
                         scales: torch.Tensor) -> torch.Tensor:
    """a_stack (P, M, K) x b_stack (P, K, N) int8 pre-mapped planes
    (P <= MAX_RANK + 1), scales (P,) f32 -> (M, N) f32.  On CUDA: (M, K, N)
    multiples of `qk.STACKED_TILE`."""
    if a_stack.device.type == "cpu":
        return approx_qgemm_stacked_plain(a_stack, b_stack, scales)
    name = "approx_qgemm_stacked"
    m, k, n = _check_tiled(name, a_stack, b_stack, qk.STACKED_TILE, 3)
    planes = a_stack.shape[0]
    scales = scales.reshape(-1).to(torch.float32).contiguous()
    if not 0 < planes <= qk.MAX_RANK + 1 or scales.shape[0] != planes:
        raise ValueError(f"{name}: {planes} planes with "
                         f"{scales.shape[0]} scales (at most "
                         f"{qk.MAX_RANK + 1} planes)")
    _check_cuda(name, a_stack, b_stack, scales)
    out = torch.empty((m, n), dtype=torch.float32, device=a_stack.device)
    lib = build.load()
    err = lib.repro_qgemm_stacked(
        a_stack.data_ptr(), b_stack.data_ptr(), scales.data_ptr(),
        out.data_ptr(), planes, m, k, n, build.stream_ptr(a_stack.device))
    build.check(err, name)
    approx_qgemm_stacked.launches += 1
    return out


approx_qgemm_stacked.launches = 0
