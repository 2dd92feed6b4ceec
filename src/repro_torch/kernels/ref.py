"""Plain PyTorch oracles for the kernels (the semantic definitions the
kernels and the plain paths are held against in the tests)."""

from __future__ import annotations

import torch

from repro_torch.approx import quant


def lut_matmul(a_q: torch.Tensor, b_q: torch.Tensor,
               lut: torch.Tensor) -> torch.Tensor:
    """Exact approximate-multiplier GEMM by 2-D LUT gather.

    a_q (m, k) int8, b_q (k, n) int8, lut (256, 256) int32 indexed by the
    uint8 bit patterns.  Returns (m, n) int32: sum_k lut[a[mk], b[kn]].
    O(mkn) memory — small shapes only."""
    ua = torch.bitwise_and(a_q.to(torch.int64), 0xFF)
    ub = torch.bitwise_and(b_q.to(torch.int64), 0xFF)
    prod = lut.to(torch.int64)[ua[:, :, None], ub[None, :, :]]
    return prod.sum(dim=1).to(torch.int32)


def ref_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True) -> torch.Tensor:
    """q, k, v (bh, s, d) f32/bf16 -> (bh, s, d).  Plain softmax attention."""
    qf, kf, vf = q.float(), k.float(), v.float()
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bqd,bkd->bqk", qf, kf) * scale
    if causal:
        sq, sk = q.shape[-2], k.shape[-2]
        mask = torch.ones((sq, sk), dtype=torch.bool,
                          device=q.device).tril(diagonal=sk - sq)
        s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, vf).to(q.dtype)


def ref_quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 quantization of (m, k) f32."""
    return quant.quantize(x, axis=0)
