"""Shape helpers of the approximate int8 GEMM kernels.

The kernels themselves live in `kernels/qgemm.py` (wrappers and plain
versions) and `csrc/qgemm.cu`; this module keeps the block-shape choices
and the truncation-mask bit trick that the wrappers and the plain
versions share, under the names the JAX package uses, and the launch
model of every kernel variant (the shared memory, block and grid its
launcher requests), which `repro_torch.analysis.contracts` holds to the
kernel library and to the card.
"""

from __future__ import annotations

from typing import NamedTuple

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


# ---------------------------------------------------------------------------
# Launch model: the dynamic shared memory, block and grid each kernel
# variant's launcher requests, from the .cu files' own constants.  The
# JAX package keeps its VMEM model here (fused_vmem_bytes and its
# siblings); `repro_torch.analysis.contracts` holds this model to the
# library's host-only query (csrc/query.cu) on the card, and dispatch's
# plans to the card's opt-in limit per block.
# ---------------------------------------------------------------------------

#: Kernel ids of the library's query (csrc/query.cu).
QUERY_IDS = {"quantize_rows": 0, "plane0": 1, "plane0_reduce": 2,
             "skinny": 3, "fused": 4, "fused_b_planes": 5, "stacked": 6,
             "flash_attention": 7}

#: csrc/qgemm.cu: plane 0's ring of 4 stages, each the A and weight tiles
#: (64 rows each) of 128 K bytes plus 16 bytes of pad a row (ldmatrix).
PLANE0_STAGES, PLANE0_BK, PLANE0_PAD = 4, 128, 16
PLANE0_THREADS = PLANE0_TILE[0] * PLANE0_TILE[2] // 32
#: csrc/qgemm.cu: the low-rank kernels' 4 stages of a 128 x 128 A tile and
#: a BN x 128 weight tile, 1024 bytes of alignment slack, the 8 x 256
#: tables and one 8-byte mbarrier a stage; 256 threads.
LOWRANK_STAGES, LOWRANK_BK, LOWRANK_THREADS = 4, 128, 256
#: csrc/qgemm.cu: split-K reduce and weight-plane map kernels' blocks; the
#: map kernel's grid is capped at 132 x 16 blocks.
REDUCE_THREADS, B_PLANES_THREADS, B_PLANES_MAX_BLOCKS = 64, 256, 132 * 16
#: csrc/skinny.cu: 4 stages of a 64 x 128 weight box, one consumer
#: warpgroup and a producer warp, 48 KiB of activation planes at most.
SKINNY_STAGES, SKINNY_THREADS, SKINNY_ACT_BUDGET = 4, 160, 48 * 1024
#: csrc/flash_attention.cu: one warp a block, 32 kv rows a tile, P tile
#: rows of 40 floats; query rows a block: 8 in f32, 16 in bf16.
FLASH_THREADS, FLASH_BKV, FLASH_LDP = 32, 32, 40
FLASH_BQ = {False: 8, True: 16}
#: The opt-in shared memory per block of sm_90 (an H100), which a CPU run
#: checks against; on the card `contracts` reads the card's own.
H100_SMEM_OPTIN = 232448


class LaunchModel(NamedTuple):
    smem: int                      # dynamic shared memory requested
    smem_limit: int                # the opt-in limit the launcher sets
    threads: int
    grid: tuple[int, int, int]


def plane0_smem_bytes() -> int:
    return PLANE0_STAGES * (PLANE0_TILE[0] + PLANE0_TILE[2]) * (
        PLANE0_BK + PLANE0_PAD)


def lowrank_smem_bytes(bn: int) -> int:
    return 1024 + LOWRANK_STAGES * (FUSED_TILE[0] + bn) * LOWRANK_BK + \
        MAX_RANK * 256 + 8 * LOWRANK_STAGES


def skinny_window(m: int, k: int, planes: int, splits: int,
                  gran: int) -> tuple[int, int]:
    """(activation rows in the MMA, K boxes of activation planes a block
    holds): the widest split's boxes, as many as fit the budget."""
    mp = 8 if m <= 8 else SKINNY_MAX_M
    units = -(-k // gran)
    boxes = 1
    for z in range(splits):
        kb = (z * units // splits) * gran
        ke = min(k, ((z + 1) * units // splits) * gran)
        boxes = max(boxes, -(-ke // SKINNY_BOX) - kb // SKINNY_BOX)
    fit = SKINNY_ACT_BUDGET // (planes * mp * SKINNY_BOX)
    return mp, max(1, min(boxes, fit))


def skinny_smem_bytes(planes: int, mp: int, win: int) -> int:
    """The ring, `win` boxes of each plane's activations, the fu and fv
    tables, 2 x stages mbarriers and the last-block flag, after 1024
    bytes of alignment slack."""
    return 1024 + SKINNY_STAGES * SKINNY_BM * SKINNY_BOX + \
        planes * win * mp * SKINNY_BOX + 2 * (planes - 1) * 256 + \
        2 * SKINNY_STAGES * 8 + 16


#: The skinny kernel's opt-in limit: its largest request (9 planes).
SKINNY_SMEM_LIMIT = 1024 + SKINNY_STAGES * SKINNY_BM * SKINNY_BOX + \
    SKINNY_ACT_BUDGET + 2 * MAX_RANK * 256 + 2 * SKINNY_STAGES * 8 + 16


def flash_smem_bytes(d: int, bf16: bool) -> int:
    """The Q tile, two K and two V tiles (rows padded 4 words) and the P
    tile."""
    ld, size = (d + 8, 2) if bf16 else (d + 4, 4)
    bq = FLASH_BQ[bf16]
    return (bq + 4 * FLASH_BKV) * ld * size + bq * FLASH_LDP * 4


def launch_model(kernel: str, args: tuple[int, ...]) -> LaunchModel:
    """What the launcher of `kernel` (a `QUERY_IDS` name) requests for the
    arguments its C entry point takes (csrc/query.cu lists them)."""
    if kernel == "quantize_rows":
        _m, _k, _vec, _lanes, _vecs, threads, blocks = args
        return LaunchModel(0, 0, threads, (blocks, 1, 1))
    if kernel == "plane0":
        m, k, n, k_chunk = args
        smem = plane0_smem_bytes()
        return LaunchModel(smem, smem, PLANE0_THREADS,
                           (n // PLANE0_TILE[2], m // PLANE0_TILE[0],
                            -(-k // k_chunk)))
    if kernel == "plane0_reduce":
        m, n, _splits = args
        return LaunchModel(0, 0, REDUCE_THREADS,
                           (-(-(m * n // 4) // REDUCE_THREADS), 1, 1))
    if kernel == "skinny":
        m, k, n, rank, splits, gran = args
        mp, win = skinny_window(m, k, rank + 1, splits, gran)
        return LaunchModel(skinny_smem_bytes(rank + 1, mp, win),
                           SKINNY_SMEM_LIMIT, SKINNY_THREADS,
                           (-(-n // SKINNY_BM), splits, 1))
    if kernel in ("fused", "stacked"):
        m, _k, n, bn, _rank_or_planes = args
        smem = lowrank_smem_bytes(bn)
        return LaunchModel(smem, smem, LOWRANK_THREADS,
                           ((m // FUSED_TILE[0]) * (n // bn), 1, 1))
    if kernel == "fused_b_planes":
        n, k, _rank = args
        blocks = min(-(-(n * k // 16) // B_PLANES_THREADS),
                     B_PLANES_MAX_BLOCKS)
        return LaunchModel(0, 0, B_PLANES_THREADS, (blocks, 1, 1))
    if kernel == "flash_attention":
        bh, sq, _skv, d, bf16 = args
        smem = flash_smem_bytes(d, bool(bf16))
        return LaunchModel(smem, smem, FLASH_THREADS,
                           (-(-sq // FLASH_BQ[bool(bf16)]), bh, 1))
    raise ValueError(f"no launch model for kernel {kernel!r}")
