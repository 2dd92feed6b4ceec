"""Shape helpers of the approximate int8 GEMM kernels.

The kernels themselves live in `kernels/qgemm.py` (wrappers and plain
versions) and `csrc/qgemm.cu`; this module keeps the block-shape choices
and the truncation-mask bit trick that the wrappers and the plain
versions share, under the names the JAX package uses.
"""

from __future__ import annotations

#: (M, K, N) multiples of the plane-0 kernel: its 64 x 64 block tile and
#: 64-byte K stage (csrc/qgemm.cu PL0_BM, PL0_BK, PL0_BN).
PLANE0_TILE = (64, 64, 64)
#: (M, K, N) multiples of the fused low-rank kernel: its 128 x 128 block
#: tile and 32-byte K multiple (csrc/qgemm.cu LR_*, lowrank_kernel) ...
FUSED_TILE = (128, 32, 128)
#: ... and of its 128 x 64 variant, which takes an N that the wide tile
#: would pad more (`fused_tile`).
FUSED_TILE_NARROW = (128, 32, 64)
#: (M, K, N) multiples of the stacked kernel (the fused kernel's tiles).
STACKED_TILE = FUSED_TILE
#: (K, N) multiples of the skinny kernel: K in 16 bytes (TMA's row stride);
#: N unpadded (TMA fills zeros past the weight's last row).
SKINNY_TILE = (16, 1)
#: The skinny kernel's block: 64 weight rows (output columns), one wgmma M,
#: streamed in 128-byte K boxes (csrc/skinny.cu SK_BM, SK_BK) ...
SKINNY_BM = 64
SKINNY_BOX = 128
#: ... and at most this many boxes (2 KiB of K) a split: a large weight
#: splits into many blocks, so its last wave leaves few SMs idle.
SKINNY_MAX_BOXES = 16

#: Largest M the decode-shaped skinny kernel accepts: one decode step of a
#: continuous-batching arena (m = batch).  Above it the tiled kernels take
#: the GEMM.
SKINNY_MAX_M = 32
#: Largest rank the fused and skinny kernels take (their shared-memory
#: tables hold 8 planes); the stacked kernel takes MAX_RANK + 1 planes.
MAX_RANK = 8


def fused_tile(n: int) -> tuple[int, int, int]:
    """The low-rank kernels' tile for N columns: the 128 x 64 variant where
    it pads N to fewer columns than the 128 x 128 one (N = 64, 192, ...),
    else the 128 x 128 one.  An N padded to either tile's width maps back
    to that tile."""
    wide, narrow = FUSED_TILE[2], FUSED_TILE_NARROW[2]
    if -(-n // narrow) * narrow < -(-n // wide) * wide:
        return FUSED_TILE_NARROW
    return FUSED_TILE


def choose_blocks(m: int, k: int, n: int, bm: int | None = None,
                  bk: int | None = None, bn: int | None = None, *,
                  kernel: str = "plane0") -> tuple[int, int, int]:
    """Padding multiples for an (m, k, n) GEMM on one of the tiled kernels
    ("plane0", "fused" or "stacked"): that kernel's own tile (for the
    low-rank kernels, the variant `fused_tile` picks from n), so operands
    pad by no more than the kernel needs."""
    tm, tk, tn = PLANE0_TILE if kernel == "plane0" else fused_tile(n)
    return bm or tm, bk or tk, bn or tn


def choose_skinny_blocks(k: int, n: int, bk: int | None = None,
                         bn: int | None = None) -> tuple[int, int]:
    """(bk, bn) padding multiples for the skinny kernel (M is never
    padded — the whole row batch rides in every block)."""
    tk, tn = SKINNY_TILE
    return bk or tk, bn or tn


def signed_trunc_mask(t: int) -> int:
    """Two's-complement signed value of the uint8 LSB-truncation mask
    0xFF & ~((1<<t)-1); -1 (all bits set) when t <= 0 (no truncation)."""
    if t <= 0:
        return -1
    return ((0xFF & ~((1 << t) - 1)) ^ 0x80) - 0x80
