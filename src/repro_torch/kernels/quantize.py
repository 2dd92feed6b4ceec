"""Fused per-row symmetric int8 quantization: the CUDA kernel's wrapper
(csrc/quantize.cu), its launch plan and its plain PyTorch version.

A CUDA tensor goes to the kernel, a CPU tensor to the plain version; the
two are bit-identical (and both bit-identical to the JAX package's
`quantize_rows`): scale = max(absmax, 1e-8) * f32(1/127) (the multiply
XLA compiles `/ 127` into), q = x / scale as an IEEE divide, round half to
even, clip, and the LSB-truncation mask after rounding.  NaN propagates
through the absmax and the floor, and a NaN quotient casts to code 0: a
row holding a NaN gets scale NaN and codes 0, a row holding +-inf scale
inf and codes 0.

`launch_plan(m, k, ld, base, sm_count=)` is the kernel's launch plan on a
card of `sm_count` SMs: how many lanes (threads) share a row, how many
units (a 16-byte float4, or 4 scalars) each lane holds in registers, and
which variant runs (16-byte loads, or scalar loads where K, the row
stride or the base is not 16-byte aligned).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.approx.quant import INT8_MAX, INV_INT8_MAX
from repro_torch.device import sm_count as device_sm_count
from repro_torch.kernels import approx_qgemm as qk
from repro_torch.kernels import build

#: The register template's largest unit count a lane holds, by variant:
#: 8 float4s (32 floats) with 16-byte loads, 5 units (20 scalars) with
#: scalar loads, whose indexing takes more of the 64 registers a thread
#: has in a 1024-thread block (csrc/quantize.cu).
MAX_VECS = {True: 8, False: 5}
#: Lanes per row: at least 4, at most one block of 1024 threads; rows
#: spread over more lanes than they need only up to SPREAD_LANES.
MIN_LANES, MAX_LANES, SPREAD_LANES = 4, 1024, 512
#: Threads per block where rows share a block.
BLOCK_THREADS = 256
#: Resident threads per SM: a grid below SMs x this runs in one wave.
_THREADS_PER_SM = 2048


class QuantPlan(NamedTuple):
    vec: bool     # 16-byte loads; False: the scalar variant
    lanes: int    # threads per row (a power of two)
    vecs: int     # units a lane holds; 0: the two-pass loop for long rows
    threads: int  # per block
    blocks: int


@functools.lru_cache(maxsize=1024)
def _plan(m: int, k: int, vec: bool, sm_count: int) -> QuantPlan:
    units, max_vecs = -(-k // 4), MAX_VECS[vec]
    if units > MAX_LANES * max_vecs:
        # beyond the register template (K > 32768, or 20480 with scalar
        # loads): one block per row and a second pass over the row
        return QuantPlan(vec, MAX_LANES, 0, MAX_LANES, m)
    lanes = MIN_LANES
    while -(-units // lanes) > max_vecs:
        lanes *= 2
    # few rows: spread each row over more lanes while the grid still fits
    # the card in one wave, so that each lane's chain of loads and divides
    # stays short
    while (lanes < SPREAD_LANES and -(-units // lanes) > 1
           and 2 * lanes * m <= sm_count * _THREADS_PER_SM):
        lanes *= 2
    threads = max(BLOCK_THREADS, lanes)
    return QuantPlan(vec, lanes, -(-units // lanes), threads,
                     -(-m // (threads // lanes)))


def launch_plan(m: int, k: int, ld: int | None = None, base: int = 0, *,
                sm_count: int) -> QuantPlan:
    """The kernel's plan for m rows of k f32 with row stride `ld`
    (elements, default k) starting at byte address `base`, on a card of
    `sm_count` SMs.  The 16-byte variant needs k, ld and base 16-byte
    aligned."""
    ld = k if ld is None else ld
    return _plan(m, k, k % 4 == 0 and ld % 4 == 0 and base % 16 == 0,
                 sm_count)


def quantize_rows_plain(x: torch.Tensor, trunc: int = 0
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (M, K) f32 -> (q (M, K) int8, scale (M, 1) f32)."""
    absmax = x.abs().amax(dim=1, keepdim=True)
    scale = torch.clamp(absmax, min=1e-8) * INV_INT8_MAX
    q = torch.clamp(torch.round(x / scale), -INT8_MAX - 1, INT8_MAX)
    qi = q.to(torch.int8)
    if trunc > 0:
        qi = torch.bitwise_and(qi, qk.signed_trunc_mask(trunc))
    return qi, scale


def quantize_rows(x: torch.Tensor, *, trunc: int = 0
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(M, K) f32 -> int8 rows + (M, 1) f32 scales, with the trunc mask
    fused in.  Launches the CUDA kernel for a CUDA tensor; its rows may
    have any row stride (a row slice of a larger tensor is read in place)."""
    if x.device.type == "cpu":
        return quantize_rows_plain(x, trunc)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_rows: unsupported device {x.device}")
    if x.dtype != torch.float32 or x.ndim != 2:
        raise ValueError("quantize_rows takes a 2-D float32 tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    m, k = x.shape
    if k > 1 and x.stride(1) != 1:
        x = x.contiguous()                 # the kernel reads unit-stride rows
    ld = x.stride(0) if m > 1 else k
    plan = launch_plan(m, k, ld, x.data_ptr(),
                       sm_count=device_sm_count(x.device))
    q = torch.empty((m, k), dtype=torch.int8, device=x.device)
    s = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    lib = build.load()
    err = lib.repro_quantize_rows(x.data_ptr(), q.data_ptr(), s.data_ptr(),
                                  m, k, ld, int(plan.vec), plan.lanes,
                                  plan.vecs, plan.threads, plan.blocks,
                                  qk.signed_trunc_mask(trunc),
                                  build.stream_ptr(x.device))
    build.check(err, "quantize_rows")
    quantize_rows.launches += 1
    return q, s


quantize_rows.launches = 0
