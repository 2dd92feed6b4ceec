"""Shape helpers of the approximate int8 GEMM kernels.

The kernels themselves live in `kernels/qgemm.py` (wrappers and plain
versions) and `csrc/qgemm.cu`; this module keeps the block-shape choices
and the truncation-mask bit trick that the wrappers and the plain
versions share, under the names the JAX package uses.
"""

from __future__ import annotations

#: (M, K, N) multiples the plane-0 kernel tiles by (csrc/qgemm.cu P0_*).
PLANE0_TILE = (128, 32, 128)
#: (K, N) multiples of the skinny kernel: 32-bit words of K, and 128
#: columns per block (csrc/qgemm.cu SK_BN).
SKINNY_TILE = (4, 128)

#: Largest M the decode-shaped skinny kernel accepts: one decode step of a
#: continuous-batching arena (m = batch).  Above it the tiled plane-0
#: kernel takes the GEMM.
SKINNY_MAX_M = 32


def choose_blocks(m: int, k: int, n: int, bm: int | None = None,
                  bk: int | None = None, bn: int | None = None
                  ) -> tuple[int, int, int]:
    """Padding multiples for an (m, k, n) GEMM on the plane-0 kernel: its
    tile, so operands pad by no more than the kernel needs."""
    tm, tk, tn = PLANE0_TILE
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
