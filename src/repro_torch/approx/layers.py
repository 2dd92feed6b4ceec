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


def _out_dim(w) -> int:
    """The whole output dim of a weight of any form `_as_weight` takes."""
    if gemm_mod.is_prepared(w):
        return w.wq.shape[-1] * w.tp
    if quant.is_qweight(w):
        return w["q"].shape[-1]
    return w.shape[-1]


def column_split(w) -> int:
    """How many column blocks `gemm(x, w, gather=False)` splits its output
    into under the active mesh (1: the whole output comes back): the
    model-axis size where it divides the output dim."""
    return gemm_mod._tp_mesh(_out_dim(w))[1]


def gather_cols(y: torch.Tensor, split: int) -> torch.Tensor:
    """Reassemble an output split `split` ways over the model axis (a
    `gemm(..., gather=False)` block, or any tensor the ranks hold by
    column blocks) into the whole tensor; identity at split 1."""
    if split == 1:
        return y
    from repro_torch.sharding import ctx
    return ctx.active_mesh().all_gather(y)


class _ColumnMatmul(torch.autograd.Function):
    """The exact GEMM run column-parallel: x times the rank's column
    block of the float weight, gathered unless `gather` is False.  The
    backward takes the whole gradient (`gemm_mod.block_grad`) and runs
    one device's matmul backward on the whole x and w, so dx and dw have
    one device's bits."""

    @staticmethod
    def forward(ctx, x, wf, mesh, gather):
        ctx.save_for_backward(x, wf)
        ctx.block_of = None if gather else mesh
        y = torch.matmul(x, mesh.shard_cols(wf).to(x.dtype))
        return mesh.all_gather(y) if gather else y

    @staticmethod
    def backward(ctx, g):
        x, wf = ctx.saved_tensors
        g = gemm_mod.block_grad(g, ctx.block_of)
        xd = x.detach().requires_grad_(ctx.needs_input_grad[0])
        wd = wf.detach().requires_grad_(ctx.needs_input_grad[1])
        wanted = [t for t in (xd, wd) if t.requires_grad]
        with torch.enable_grad():
            grads = iter(torch.autograd.grad(
                torch.matmul(xd, wd.to(xd.dtype)), wanted, g))
        return (next(grads) if xd.requires_grad else None,
                next(grads) if wd.requires_grad else None, None, None)


class _BlockBias(torch.autograd.Function):
    """y (the rank's column block of a column-parallel output) plus the
    rank's block of the whole bias b; b's gradient is one device's: the
    whole gradient summed to b's shape."""

    @staticmethod
    def forward(ctx, y, b, mesh):
        ctx.mesh, ctx.b_meta = mesh, (tuple(b.shape), b.dtype)
        return y + mesh.shard_cols(b)

    @staticmethod
    def backward(ctx, g):
        shape, dtype = ctx.b_meta
        whole = gemm_mod.block_grad(g, ctx.mesh)
        return g, whole.sum_to_size(shape).to(dtype), None


def gemm(x: torch.Tensor, w, spec: gemm_mod.MultSpec | None = None,
         policy: str | None = None, gather: bool = True) -> torch.Tensor:
    """x (..., k) @ w (k, n), approximate if the spec says so.  `policy`
    overrides the spec-carried kernel-dispatch policy for this call.

    Under an active mesh (`sharding.ctx`) a GEMM whose n divides the model
    axis runs column-parallel, each rank on its block of columns, exact
    and approximate alike; the output is all-gathered, or, with
    `gather=False`, the rank's block comes back (`column_split` says
    which).  Gradients are one device's either way."""
    if spec is None or spec.is_exact:
        wf = _as_weight(w, x.dtype)
        mesh, split = gemm_mod._tp_mesh(_out_dim(w))
        if split > 1 and gemm_mod.is_prepared(w) and w.tp > 1:
            y = torch.matmul(x, wf.to(x.dtype))   # `w` is the rank's block
            return gather_cols(y, split) if gather else y
        if split > 1:
            return _ColumnMatmul.apply(x, wf, mesh, gather)
        return torch.matmul(x, wf.to(x.dtype))
    if policy is not None:
        spec = spec.with_policy(policy)
    if gemm_mod.is_prepared(w):
        return gemm_mod.approx_matmul_prepared(x, w, spec, gather)
    return gemm_mod.approx_matmul(x, _as_weight(w, x.dtype), spec, gather)


def dense(x: torch.Tensor, w, b: torch.Tensor | None = None,
          spec: gemm_mod.MultSpec | None = None,
          policy: str | None = None, gather: bool = True) -> torch.Tensor:
    """Linear layer.  The bias add stays exact (the paper approximates the
    MAC multipliers; accumulators/adders are exact).  With `gather=False`
    a column-parallel output takes the rank's block of the bias."""
    y = gemm(x, w, spec, policy, gather)
    if b is None:
        return y
    if not gather and column_split(w) > 1:
        from repro_torch.sharding import ctx
        return _BlockBias.apply(y, b, ctx.active_mesh())
    return y + b


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
