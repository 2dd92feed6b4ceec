"""Approximate int8 GEMM kernels: wrappers of the CUDA kernels in
csrc/qgemm.cu and their plain PyTorch versions.

`approx_qgemm_plane0` — exact / truncation multipliers, any M: one masked
int8 product accumulated in int32, f32 out.  It takes the weight K-major,
as (N, K): both MMA operands are then K-major and tiles copy to shared
memory without a transpose.  `plane0_splits` chooses its split of K from
the card's SM count, or a plan asks for one (`plane0_split_plan`).

`approx_qgemm_fused` — low-rank multipliers, any M: plane 0 plus R
table-mapped correction planes (tables (R, 256) int8 indexed by
`q & 0xFF`, mapped A zeroed past `k_valid`), each plane an int32 sum,
flushed in plane order as `acc = acc + s_r * acc_r` in f32.  It takes
the weight K-major too, and its tile's width from a plan, else from N
(`qk.fused_tile`).

`approx_qgemm_skinny` — the same planes for decode-shaped GEMMs
(m <= SKINNY_MAX_M), on the weight K-major too.  `skinny_splits` is its
split of K (or a plan's, `skinny_gran`); its int32 workspace and per-tile
counters belong to the device (`_skinny_scratch`), so a call allocates
only its output.

Every split and tile width sums the same exact int32 planes and flushes
them in the same order, so a plan's knobs move time, never bits.

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
from repro_torch.device import sm_count as device_sm_count
from repro_torch.kernels import approx_qgemm as qk
from repro_torch.kernels import build


def lowrank_b_planes_plain(b_t: torch.Tensor, fv_q: torch.Tensor, *,
                           trunc_b: int = 0) -> torch.Tensor:
    """The (R+1, N, K) weight planes that the fused kernel makes once per
    call from the K-major weight b_t (N, K): plane 0 the (masked) weight,
    plane r its map through fv_q[r-1]."""
    return torch.stack([_trunc_mask(b_t, trunc_b)] +
                       [_table_map(fv_q[r], b_t)
                        for r in range(fv_q.shape[0])])


def planes_plain(a_q: torch.Tensor, b_q: torch.Tensor, fu_q: torch.Tensor,
                 fv_q: torch.Tensor, scales: torch.Tensor | None, *,
                 trunc_a: int = 0, trunc_b: int = 0,
                 k_valid: int | None = None) -> torch.Tensor:
    """The plane semantic every approximate GEMM kernel computes:
    a_q (M, K) x b_q (K, N) int8, fu_q/fv_q (R, 256) int8 tables, scales
    (R+1,) f32 with scales[0] = 1 and scales[r] = -s_r (None at rank 0:
    the one plane's scale is 1) -> (M, N) f32.  A is masked (plane 0) or
    mapped and zeroed at k >= k_valid (plane r), each plane an exact int32
    product, flushed in plane order."""
    k = a_q.shape[1]
    k_valid = k if k_valid is None else k_valid
    b_planes = lowrank_b_planes_plain(b_q.T, fv_q, trunc_b=trunc_b)
    in_k = (torch.arange(k, device=a_q.device) < k_valid)[None, :]
    zero = torch.zeros((), dtype=torch.int8, device=a_q.device)
    out = torch.zeros((a_q.shape[0], b_q.shape[1]), dtype=torch.float32,
                      device=a_q.device)
    for p in range(b_planes.shape[0]):
        ua = _trunc_mask(a_q, trunc_a) if p == 0 else \
            torch.where(in_k, _table_map(fu_q[p - 1], a_q), zero)
        scale = 1.0 if scales is None else scales[p]
        out = out + scale * qgemm_int32(ua, b_planes[p].T).to(torch.float32)
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


def approx_qgemm_plane0_plain(a_q: torch.Tensor, b_t: torch.Tensor, *,
                              trunc_a: int = 0, trunc_b: int = 0
                              ) -> torch.Tensor:
    return qgemm_int32(_trunc_mask(a_q, trunc_a),
                       _trunc_mask(b_t, trunc_b).T).to(torch.float32)


def plane0_split_plan(k: int, splits: int) -> tuple[int, int]:
    """(splits, k_chunk) of the plane-0 kernel's K when at least `splits`
    splits are asked for: k_chunk is whole K tiles, the largest that makes
    that many, so split z sums K rows [z * k_chunk, (z + 1) * k_chunk).
    The count it returns asks for itself again.  Raises when K has fewer
    tiles than `splits`."""
    tk = qk.PLANE0_TILE[1]
    k_tiles = -(-k // tk)
    if not 1 <= splits <= k_tiles:
        raise ValueError(f"plane 0: {splits} K splits of {k_tiles} K tiles")
    chunk = -(-k_tiles // splits)
    while chunk > 1 and -(-k_tiles // chunk) < splits:
        chunk -= 1
    return -(-k_tiles // chunk), chunk * tk


def plane0_splits(m: int, k: int, n: int, *,
                  sm_count: int) -> tuple[int, int]:
    """(splits, k_chunk) of the plane-0 kernel's K for an (m, k, n) GEMM on
    a card of `sm_count` SMs (`plane0_split_plan`).  A grid of at most
    half the SMs splits K until it covers every SM; a larger grid would
    only gain a second wave."""
    tm, tk, tn = qk.PLANE0_TILE
    blocks = -(-m // tm) * -(-n // tn)
    k_tiles = -(-k // tk)
    if 2 * blocks > sm_count:
        return 1, k_tiles * tk
    return plane0_split_plan(k, min(-(-sm_count // blocks), k_tiles))


def approx_qgemm_plane0(a_q: torch.Tensor, b_t: torch.Tensor, *,
                        trunc_a: int = 0, trunc_b: int = 0,
                        splits: int | None = None) -> torch.Tensor:
    """a_q (M, K) x b_t (N, K) int8, the weight K-major -> f32 (M, N),
    truncation masks in the kernel.  On CUDA: (M, K, N) multiples of
    `qk.PLANE0_TILE`.  `splits` asks for a split of K
    (`plane0_split_plan`); None takes `plane0_splits`' for the card."""
    planned = None if splits is None else \
        plane0_split_plan(a_q.shape[1], splits)
    if a_q.device.type == "cpu":
        return approx_qgemm_plane0_plain(a_q, b_t, trunc_a=trunc_a,
                                         trunc_b=trunc_b)
    m, k = a_q.shape
    n, k2 = b_t.shape
    if a_q.dtype != torch.int8 or b_t.dtype != torch.int8 or k != k2:
        raise ValueError(f"approx_qgemm_plane0: bad operands {a_q.dtype} "
                         f"{tuple(a_q.shape)} x {b_t.dtype} "
                         f"{tuple(b_t.shape)} (K-major)")
    tm, tk, tn = qk.PLANE0_TILE
    if not (m and k and n) or m % tm or k % tk or n % tn:
        raise ValueError(f"approx_qgemm_plane0: ({m}, {k}, {n}) is not "
                         f"padded to {qk.PLANE0_TILE} multiples")
    _check_cuda("approx_qgemm_plane0", a_q, b_t)
    splits, k_chunk = planned or plane0_splits(
        m, k, n, sm_count=device_sm_count(a_q.device))
    out = torch.empty((m, n), dtype=torch.float32, device=a_q.device)
    ws = torch.empty((splits, m, n), dtype=torch.int32,
                     device=a_q.device) if splits > 1 else None
    lib = build.load()
    err = lib.repro_qgemm_plane0(
        a_q.data_ptr(), b_t.data_ptr(), out.data_ptr(),
        ws.data_ptr() if ws is not None else None, m, k, n,
        qk.signed_trunc_mask(trunc_a), qk.signed_trunc_mask(trunc_b),
        k_chunk, build.stream_ptr(a_q.device))
    build.check(err, "approx_qgemm_plane0")
    approx_qgemm_plane0.launches += 1
    return out


approx_qgemm_plane0.launches = 0


def skinny_splits(k: int, n: int, *, sm_count: int) -> tuple[int, int]:
    """(splits, gran) of the skinny kernel's K for a (K, N) weight on a
    card of `sm_count` SMs: split z sums the K units [z U / S, (z + 1) U /
    S) of `gran` bytes (U the units of K), so none is empty while S <= U.
    S is the least that brings the grid of ceil(N / 64) tiles to every SM
    and keeps each split within SKINNY_MAX_BOXES 128-byte boxes of K;
    units are whole boxes where K has enough of them, else 32 bytes (one
    MMA step)."""
    tiles = -(-n // qk.SKINNY_BM)
    boxes = -(-k // qk.SKINNY_BOX)
    want = max(-(-sm_count // tiles), -(-boxes // qk.SKINNY_MAX_BOXES))
    if want <= boxes:
        return want, qk.SKINNY_BOX
    return min(want, -(-k // 32)), 32


def skinny_gran(k: int, splits: int) -> int:
    """The unit of K (bytes) of a skinny call that asks for `splits`
    splits, as `skinny_splits` picks it: whole 128-byte boxes where K has
    that many, else 32 bytes.  Raises when K has fewer 32-byte units."""
    if not 1 <= splits <= -(-k // 32):
        raise ValueError(f"skinny: {splits} K splits of K = {k}")
    return qk.SKINNY_BOX if splits <= -(-k // qk.SKINNY_BOX) else 32


#: Per device: the skinny kernel's int32 split workspace and its per-tile
#: arrival counters, both of which every call leaves at 0.  Grown, never
#: shrunk; calls on one stream run in order, so they share them.
_skinny_state: dict = {}


def _skinny_scratch(device: torch.device, tiles: int, ws_elems: int
                    ) -> tuple[torch.Tensor, torch.Tensor | None]:
    counters, ws = _skinny_state.get(device.index, (None, None))
    if counters is None or counters.numel() < tiles:
        counters = torch.zeros(max(tiles, 1024), dtype=torch.int32,
                               device=device)
    if ws_elems and (ws is None or ws.numel() < ws_elems):
        ws = torch.zeros(ws_elems, dtype=torch.int32, device=device)
    _skinny_state[device.index] = (counters, ws)
    return counters, ws if ws_elems else None


def approx_qgemm_skinny_plain(a_q, b_t, fu_q, fv_q, scales=None, *,
                              trunc_a: int = 0, trunc_b: int = 0,
                              k_valid: int) -> torch.Tensor:
    """The skinny kernel's planes on the K-major weight b_t (N, K)."""
    return planes_plain(a_q, b_t.T, fu_q, fv_q,
                        None if scales is None else scales.reshape(-1),
                        trunc_a=trunc_a, trunc_b=trunc_b, k_valid=k_valid)


def approx_qgemm_skinny(a_q: torch.Tensor, b_t: torch.Tensor,
                        fu_q: torch.Tensor, fv_q: torch.Tensor,
                        scales: torch.Tensor | None = None, *,
                        trunc_a: int = 0, trunc_b: int = 0,
                        k_valid: int, splits: int | None = None
                        ) -> torch.Tensor:
    """a_q (m <= 32, K) x b_t (N, K) int8, the weight K-major, fu_q/fv_q
    (R, 256) int8 tables (R may be 0), scales (R+1,) f32 (None at rank 0)
    -> (m, N) f32.  On CUDA: K a multiple of `qk.SKINNY_TILE`'s; m and N
    are consumed unpadded.  `splits` asks for a split of K (its unit by
    `skinny_gran`); None takes `skinny_splits`' for the card."""
    gran = None if splits is None else skinny_gran(a_q.shape[-1], splits)
    if a_q.device.type == "cpu":
        return approx_qgemm_skinny_plain(a_q, b_t, fu_q, fv_q, scales,
                                         trunc_a=trunc_a, trunc_b=trunc_b,
                                         k_valid=k_valid)
    name = "approx_qgemm_skinny"
    if a_q.ndim != 2 or b_t.ndim != 2 or a_q.dtype != torch.int8 or \
            b_t.dtype != torch.int8 or a_q.shape[1] != b_t.shape[1]:
        raise ValueError(f"{name}: bad operands {a_q.dtype} "
                         f"{tuple(a_q.shape)} x {b_t.dtype} "
                         f"{tuple(b_t.shape)} (K-major)")
    m, k = a_q.shape
    n = b_t.shape[0]
    tk, tn = qk.SKINNY_TILE
    if not 0 < m <= qk.SKINNY_MAX_M or not (k and n) or k % tk or n % tn:
        raise ValueError(f"{name}: ({m}, {k}, {n}) needs m <= "
                         f"{qk.SKINNY_MAX_M} and (K, N) padded to "
                         f"{qk.SKINNY_TILE} multiples")
    if not 0 < k_valid <= k:
        raise ValueError(f"{name}: k_valid {k_valid} vs {k}")
    rank = fu_q.shape[0]
    if scales is not None:
        scales = scales.reshape(-1).to(torch.float32).contiguous()
    if rank > qk.MAX_RANK or fu_q.shape != (rank, 256) or \
            fv_q.shape != fu_q.shape or (rank and scales is None) or \
            (scales is not None and scales.shape[0] != rank + 1):
        raise ValueError(f"{name}: tables {tuple(fu_q.shape)} / "
                         f"{tuple(fv_q.shape)} and scales "
                         f"{None if scales is None else tuple(scales.shape)}"
                         f" do not match a rank <= {qk.MAX_RANK}")
    tensors = [a_q, b_t]
    if scales is not None:
        tensors.append(scales)
    if rank:
        fu_q, fv_q = fu_q.contiguous(), fv_q.contiguous()
        tensors += [fu_q, fv_q]
    _check_cuda(name, *tensors)
    if splits is None:
        splits, gran = skinny_splits(k, n,
                                     sm_count=device_sm_count(a_q.device))
    tiles = -(-n // qk.SKINNY_BM)
    rows = 8 if m <= 8 else qk.SKINNY_MAX_M     # activation rows in the MMA
    counters, ws = _skinny_scratch(
        a_q.device, tiles,
        (rank + 1) * tiles * qk.SKINNY_BM * rows if splits > 1 else 0)
    out = torch.empty((m, n), dtype=torch.float32, device=a_q.device)
    lib = build.load()
    err = lib.repro_qgemm_skinny(
        a_q.data_ptr(), b_t.data_ptr(),
        fu_q.data_ptr() if rank else None, fv_q.data_ptr() if rank else None,
        scales.data_ptr() if scales is not None else None,
        ws.data_ptr() if ws is not None else None, counters.data_ptr(),
        out.data_ptr(), m, k, n, k_valid, rank,
        qk.signed_trunc_mask(trunc_a), qk.signed_trunc_mask(trunc_b),
        splits, gran, build.stream_ptr(a_q.device))
    build.check(err, name)
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


def approx_qgemm_fused_plain(a_q: torch.Tensor, b_t: torch.Tensor,
                             fu_q: torch.Tensor, fv_q: torch.Tensor,
                             scales: torch.Tensor, *, trunc_a: int = 0,
                             trunc_b: int = 0, k_valid: int
                             ) -> torch.Tensor:
    """The fused kernel's planes on the K-major weight b_t (N, K)."""
    return planes_plain(a_q, b_t.T, fu_q, fv_q, scales.reshape(-1),
                        trunc_a=trunc_a, trunc_b=trunc_b, k_valid=k_valid)


def _tile_width(name: str, n: int, bn: int | None) -> int:
    """The low-rank kernels' tile width for N columns: `bn` (64 or 128)
    where a plan asks for one, else `qk.fused_tile(n)`'s."""
    if bn is None:
        return qk.fused_tile(n)[2]
    if bn not in (qk.FUSED_TILE_NARROW[2], qk.FUSED_TILE[2]) or n % bn:
        raise ValueError(f"{name}: tile width {bn} for N = {n} (64 or "
                         "128, dividing N)")
    return bn


def approx_qgemm_fused(a_q: torch.Tensor, b_t: torch.Tensor,
                       fu_q: torch.Tensor, fv_q: torch.Tensor,
                       scales: torch.Tensor, *, trunc_a: int = 0,
                       trunc_b: int = 0, k_valid: int,
                       bn: int | None = None) -> torch.Tensor:
    """a_q (M, K) x b_t (N, K) raw int8, the weight K-major, fu_q/fv_q
    (R, 256) int8 tables (R <= 8), scales (R+1,) f32 -> (M, N) f32.
    `k_valid` is the true K before padding.  On CUDA: M and K multiples
    of `qk.FUSED_TILE`'s, N of the tile width the kernel runs: `bn` (64
    or 128), None for `qk.fused_tile(N)`'s."""
    name = "approx_qgemm_fused"
    bn = _tile_width(name, b_t.shape[0], bn)
    if a_q.device.type == "cpu":
        return approx_qgemm_fused_plain(a_q, b_t, fu_q, fv_q, scales,
                                        trunc_a=trunc_a, trunc_b=trunc_b,
                                        k_valid=k_valid)
    if a_q.ndim != 2 or b_t.ndim != 2 or a_q.dtype != torch.int8 or \
            b_t.dtype != torch.int8 or a_q.shape[1] != b_t.shape[1]:
        raise ValueError(f"{name}: bad operands {a_q.dtype} "
                         f"{tuple(a_q.shape)} x {b_t.dtype} "
                         f"{tuple(b_t.shape)} (K-major)")
    m, k = a_q.shape
    n = b_t.shape[0]
    tm, tk = qk.FUSED_TILE[:2]
    if m % tm or k % tk or n % bn or not (m and k and n):
        raise ValueError(f"{name}: ({m}, {k}, {n}) is not padded to "
                         f"{(tm, tk, bn)} multiples")
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
    tensors = [a_q, b_t, scales]
    if rank:
        fu_q, fv_q = fu_q.contiguous(), fv_q.contiguous()
        tensors += [fu_q, fv_q]
    _check_cuda(name, *tensors)
    b_planes = torch.empty((rank + 1, n, k), dtype=torch.int8,
                           device=a_q.device)
    out = torch.empty((m, n), dtype=torch.float32, device=a_q.device)
    lib = build.load()
    err = lib.repro_qgemm_fused(
        a_q.data_ptr(), b_t.data_ptr(),
        fu_q.data_ptr() if rank else None, fv_q.data_ptr() if rank else None,
        scales.data_ptr(), b_planes.data_ptr(), out.data_ptr(), m, k, n, bn,
        k_valid, rank, qk.signed_trunc_mask(trunc_a),
        qk.signed_trunc_mask(trunc_b), build.stream_ptr(a_q.device))
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
                         scales: torch.Tensor, *,
                         bn: int | None = None) -> torch.Tensor:
    """a_stack (P, M, K) x b_stack (P, K, N) int8 pre-mapped planes
    (P <= MAX_RANK + 1), scales (P,) f32 -> (M, N) f32.  On CUDA: padded
    as the fused kernel's operands, N to the tile width `bn` (None for
    `qk.fused_tile(N)`'s); the kernel takes the weight stack K-major, so
    it is transposed here."""
    name = "approx_qgemm_stacked"
    bn = _tile_width(name, b_stack.shape[-1], bn)
    if a_stack.device.type == "cpu":
        return approx_qgemm_stacked_plain(a_stack, b_stack, scales)
    m, k, n = _check_tiled(name, a_stack, b_stack, qk.FUSED_TILE_NARROW, 3)
    planes = a_stack.shape[0]
    scales = scales.reshape(-1).to(torch.float32).contiguous()
    if not 0 < planes <= qk.MAX_RANK + 1 or scales.shape[0] != planes:
        raise ValueError(f"{name}: {planes} planes with "
                         f"{scales.shape[0]} scales (at most "
                         f"{qk.MAX_RANK + 1} planes)")
    b_t = b_stack.transpose(1, 2).contiguous()
    _check_cuda(name, a_stack, b_t, scales)
    out = torch.empty((m, n), dtype=torch.float32, device=a_stack.device)
    lib = build.load()
    err = lib.repro_qgemm_stacked(
        a_stack.data_ptr(), b_t.data_ptr(), scales.data_ptr(),
        out.data_ptr(), planes, m, k, n, bn,
        build.stream_ptr(a_stack.device))
    build.check(err, name)
    approx_qgemm_stacked.launches += 1
    return out


approx_qgemm_stacked.launches = 0
