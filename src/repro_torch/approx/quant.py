"""Symmetric int8 quantization (the paper's accelerators are int8 MAC
arrays; every approximate-multiplier simulation runs on int8 tensors).

Bit-exact with the JAX package's compiled quantizer on f32 inputs: the
absmax is an exact reduction; XLA folds the constant divide `/ 127` into a
multiply by f32(1/127) in every compiled JAX program (the Pallas kernel and
the jitted XLA path), so the scale here is that same multiply; `x / scale`
stays an IEEE divide, as in XLA; and `torch.round` rounds half to even like
`jnp.round`.
"""

from __future__ import annotations

import torch

INT8_MAX = 127.0
#: f32(1 / 127): the scale is absmax times this, as compiled JAX computes it.
INV_INT8_MAX = 0.007874015718698502


def quantize(x: torch.Tensor, axis: int | tuple[int, ...] | None = None,
             eps: float = 1e-8) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric quantization to int8.

    axis=None  -> per-tensor scale (scalar)
    axis=k     -> scale is reduced over all *other* axes (per-channel along k)
    Returns (q int8, scale f32) with x ~= q * scale.
    """
    if axis is None:
        absmax = x.abs().amax()
    else:
        axes = (axis,) if isinstance(axis, int) else axis
        keep = tuple(a % x.ndim for a in axes)
        reduce_over = tuple(i for i in range(x.ndim) if i not in keep)
        absmax = x.abs().amax(dim=reduce_over, keepdim=True) \
            if reduce_over else x.abs()
    scale = torch.clamp(absmax, min=eps) * INV_INT8_MAX
    q = torch.clamp(torch.round(x / scale), -INT8_MAX - 1, INT8_MAX)
    return q.to(torch.int8), scale.to(torch.float32)


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def fake_quant(x: torch.Tensor, axis: int | None = None) -> torch.Tensor:
    """Quantize-dequantize (QAT-style error injection without approx)."""
    q, s = quantize(x, axis)
    return dequantize(q, s)


# --- int8 weight storage for serving -----------------------------------------
# A quantized weight is a {"q": int8, "s": f32} dict leaf, dequantized at
# use (`approx/layers._as_weight`), as in the JAX package.

#: weights consumed outside the GEMM layers (lookups, slices, conv taps)
_QSKIP = ("embed", "dec_pos", "conv_w")


def leaf_name(path) -> str:
    """Innermost dict key of a key path (a tuple of keys, outermost first;
    "" if none) — the param-leaf name used by the serving weight caches."""
    for part in reversed(tuple(path)):
        if isinstance(part, str):
            return part
    return ""


def quantize_param_tree(params: dict, min_size: int = 1 << 16) -> dict:
    """Per-output-channel int8 quantization of every large >= 2-D float
    weight whose last two dims are both at least 512 (true GEMM matrices,
    not stacked vectors), as {"q", "s"} leaves.  Scales are per (stack
    dims x output channel): only the contraction dim (-2) is reduced, so
    layer-stacked weights stay sliceable.  Lookups, slices and conv taps
    (`_QSKIP`) stay float."""
    def q(path, leaf):
        if isinstance(leaf, dict):
            return {k: q((*path, k), v) for k, v in leaf.items()}
        if leaf_name(path) in _QSKIP or not torch.is_tensor(leaf) or \
                leaf.ndim < 2 or leaf.numel() < min_size or \
                not leaf.is_floating_point():
            return leaf
        if leaf.shape[-1] < 512 or leaf.shape[-2] < 512:
            return leaf
        keep = tuple(i for i in range(leaf.ndim) if i != leaf.ndim - 2)
        qv, s = quantize(leaf, axis=keep)
        return {"q": qv, "s": s}
    return q((), params)


def is_qweight(w) -> bool:
    """An int8-serving {"q": int8, "s": f32} weight leaf."""
    return isinstance(w, dict) and set(w) == {"q", "s"}


def dequantize_weight(w, dtype=torch.bfloat16) -> torch.Tensor:
    return (w["q"].to(torch.float32) * w["s"]).to(dtype)
