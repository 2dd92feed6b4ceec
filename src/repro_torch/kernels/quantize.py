"""Fused per-row symmetric int8 quantization: the CUDA kernel's wrapper
(csrc/quantize.cu) and its plain PyTorch version.

A CUDA tensor goes to the kernel, a CPU tensor to the plain version; the
two are bit-identical (and both bit-identical to the JAX package's
`quantize_rows`): scale = max(absmax, 1e-8) * f32(1/127) (the multiply
XLA compiles `/ 127` into), q = x / scale as an IEEE divide, round half to
even, clip, and the LSB-truncation mask after rounding.
"""

from __future__ import annotations

import torch

from repro_torch.approx.quant import INT8_MAX, INV_INT8_MAX
from repro_torch.kernels import approx_qgemm as qk
from repro_torch.kernels import build


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
    fused in.  Launches the CUDA kernel for a CUDA tensor."""
    if x.device.type == "cpu":
        return quantize_rows_plain(x, trunc)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_rows: unsupported device {x.device}")
    if x.dtype != torch.float32 or x.ndim != 2:
        raise ValueError("quantize_rows takes a 2-D float32 tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    x = x.contiguous()
    m, k = x.shape
    q = torch.empty((m, k), dtype=torch.int8, device=x.device)
    s = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    lib = build.load()
    err = lib.repro_quantize_rows(x.data_ptr(), q.data_ptr(), s.data_ptr(),
                                  m, k, qk.signed_trunc_mask(trunc),
                                  build.stream_ptr(x.device))
    build.check(err, "quantize_rows")
    quantize_rows.launches += 1
    return q, s


quantize_rows.launches = 0
