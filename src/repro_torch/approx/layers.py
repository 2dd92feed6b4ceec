"""Model-facing approximate compute layers.

Every matmul of the models routes through `dense` / `gemm` here, so any
architecture can be evaluated under any candidate approximate multiplier.
With `spec=None` or an exact spec the layer is a plain float matmul.
(`conv2d` comes with the CNN models.)
"""

from __future__ import annotations

import torch

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


def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Embedding lookups are reads, not MACs — always exact."""
    return table[tokens]
