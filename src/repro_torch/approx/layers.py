"""Model-facing approximate compute layers.

Every matmul of the models routes through `dense` / `conv2d` / `gemm`
here, so any architecture can be evaluated under any candidate
approximate multiplier.  With `spec=None` or an exact spec the layer is a
plain float matmul or convolution.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.approx import gemm as gemm_mod
from repro_torch.approx import quant


def _as_weight(w, dtype):
    """Accepts a plain tensor, an int8-serving {"q","s"} dict leaf, or a
    serving `PreparedWeight` (degrades to its original float weight)."""
    if gemm_mod.is_prepared(w):
        return w.w
    if quant.is_qweight(w):
        return quant.dequantize_weight(w, dtype)
    return w


def gemm(x: torch.Tensor, w, spec: gemm_mod.MultSpec | None = None,
         policy: str | None = None) -> torch.Tensor:
    """x (..., k) @ w (k, n), approximate if the spec says so.  `policy`
    overrides the spec-carried kernel-dispatch policy for this call."""
    if spec is None or spec.is_exact:
        return torch.matmul(x, _as_weight(w, x.dtype).to(x.dtype))
    if policy is not None:
        spec = spec.with_policy(policy)
    if gemm_mod.is_prepared(w):
        return gemm_mod.approx_matmul_prepared(x, w, spec)
    return gemm_mod.approx_matmul(x, _as_weight(w, x.dtype), spec)


def dense(x: torch.Tensor, w, b: torch.Tensor | None = None,
          spec: gemm_mod.MultSpec | None = None,
          policy: str | None = None) -> torch.Tensor:
    """Linear layer.  The bias add stays exact (the paper approximates the
    MAC multipliers; accumulators/adders are exact)."""
    y = gemm(x, w, spec, policy)
    if b is not None:
        y = y + b
    return y


def _im2col(x: torch.Tensor, r: int, s: int, stride: int, padding: int
            ) -> tuple[torch.Tensor, int, int]:
    """x (n, h, w, c) -> patches (n, ho, wo, r*s*c), in (r, s, c) order."""
    n = x.shape[0]
    xp = F.pad(x, (0, 0, padding, padding, padding, padding))
    # unfold: (n, ho, w+2p, c, r), then (n, ho, wo, c, r, s)
    patches = xp.unfold(1, r, stride).unfold(2, s, stride)
    ho, wo = patches.shape[1], patches.shape[2]
    patches = patches.permute(0, 1, 2, 4, 5, 3)   # (n, ho, wo, r, s, c)
    return patches.reshape(n, ho, wo, -1), ho, wo


def conv2d(x: torch.Tensor, w, stride: int = 1, padding: int = 1,
           spec: gemm_mod.MultSpec | None = None,
           policy: str | None = None) -> torch.Tensor:
    """NHWC conv via im2col + (approximate) GEMM.

    x (n, h, w, c_in), w (r, s, c_in, c_out).  im2col is exactly how the
    NVDLA-style accelerator maps conv onto its MAC array, so simulated
    approximation composes correctly per-MAC.  An exact or absent spec is a
    plain float convolution (NCHW views of the NHWC operands)."""
    w = _as_weight(w, x.dtype)
    r, s, c_in, c_out = w.shape
    if spec is None or spec.is_exact:
        y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                     stride=stride, padding=padding)
        return y.permute(0, 2, 3, 1).contiguous()
    patches, ho, wo = _im2col(x, r, s, stride, padding)
    y = gemm(patches, w.reshape(r * s * c_in, c_out), spec, policy)
    return y.reshape(x.shape[0], ho, wo, c_out)


def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Embedding lookups are reads, not MACs — always exact."""
    return table[tokens]
