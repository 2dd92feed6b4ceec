"""Shared model components: norms (RMS and biased LayerNorm), RoPE and
sinusoidal positions, attention (naive / chunked / flash / windowed /
decode), the KV-cache and padding helpers, SwiGLU, the GELU MLP and the
tanh-approximate GELU.

All matmuls of the projections route through approx.layers so every model
can run under a candidate approximate multiplier (`spec`).  Softmax, norms
and rotary math stay in f32.  These are plain PyTorch ops, as they are XLA
code in the JAX package; only flash attention has a kernel.
"""

from __future__ import annotations

import functools
from typing import Any

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.approx import gemm as gemm_mod
from repro_torch.approx import layers as AL
from repro_torch.models import attention as A
from repro_torch.sharding import ctx

MultSpec = gemm_mod.MultSpec
Params = dict[str, Any]


def block_params(tree: Params, *index: int) -> Params:
    """One block's params out of a layer-stacked tree: each leaf indexed
    by `index` along its leading stack axes (a `PreparedWeight` through
    `.layer`, an int8 {"q", "s"} leaf member by member)."""
    out = {}
    for k, v in tree.items():
        for i in index:
            if gemm_mod.is_prepared(v):
                v = v.layer(i)
            elif isinstance(v, dict):
                v = {kk: vv[i] for kk, vv in v.items()}
            else:
                v = v[i]
        out[k] = v
    return out


def unstack(tree: Params, depth: int) -> Params:
    """A layer-stacked tree with each leaf split into nested lists of its
    per-block views (`torch.unbind` over the `depth` leading axes), which
    `block_params` indexes as it indexes the stacks.  Under autograd a
    block's gradient then lands in one stack per leaf: indexing the stack
    itself makes each block's backward fill a zero tensor of the whole
    stack.  Prepared and int8 {"q", "s"} leaves, which take no gradient,
    stay whole."""
    def split(x, n):
        if n == 0 or gemm_mod.is_prepared(x) or not torch.is_tensor(x):
            return x
        return [split(t, n - 1) for t in torch.unbind(x)]
    return {k: split(v, depth) for k, v in tree.items()}


# --- norms ------------------------------------------------------------------

def on_whole_rows(fn, *xs: torch.Tensor) -> torch.Tensor:
    """`fn(*xs)` on a data rank's rows (dim 0 of each x) as one device
    computes them.  Inside `sharding.ctx.whole_rows` (a data rank's
    decode step on b of the slots) the rows sit at their own offsets
    among zero rows of the whole count and the other rows of the output
    are dropped, so `fn`'s kernels see one device's shapes: on the card
    cuBLAS picks its batched products' kernel by the batch count, and
    torch's row reductions their split by the row count, and another
    kernel or split rounds otherwise (as `transformer._whole_heads` found
    for heads).  Elsewhere `fn(*xs)`."""
    block = ctx.row_block()
    if block is None or block[1] == xs[0].shape[0]:
        return fn(*xs)
    first, whole = block
    n = xs[0].shape[0]

    def pad(x):
        out = x.new_zeros((whole, *x.shape[1:]))
        out[first:first + n] = x
        return out

    return fn(*(pad(x) for x in xs))[first:first + n]


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last dim in f32 with a (1 + scale) gain; a data
    rank's decode rows reduce as one device's (`on_whole_rows`)."""
    return on_whole_rows(lambda x: _rmsnorm(x, scale, eps), x)


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor,
             eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in f32 with a (1 + scale) gain and a bias, as the JAX
    package's; a data rank's decode rows reduce as one device's
    (`on_whole_rows`)."""
    return on_whole_rows(lambda x: _layernorm(x, scale, bias, eps), x)


def _layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps) * (1.0 + scale.float()) + \
        bias.float()
    return out.to(x.dtype)


def sinusoid_positions(s: int, d: int, device=None) -> torch.Tensor:
    """(s, d) f32 sinusoidal positions: sin on the first d/2 channels, cos
    on the rest.  The power is taken in f64 and rounded once: torch's f32
    power is an ulp off XLA's on a few exponents, and at 1500 positions
    an ulp of the angle moves sin by 1e-4."""
    pos = torch.arange(s, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / (10000.0 ** (dim / d).double()).float()
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# --- rotary embeddings --------------------------------------------------------

@functools.lru_cache(maxsize=16)
def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    """(hd/2,) inverse frequencies, cached per (hd, theta, device): every
    layer of every step asks for the same ones.  Callers must not modify
    the result."""
    exps = torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x (..., s, h, hd), positions (..., s) -> same shape."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                 # (hd/2,)
    ang = positions[..., None].float() * freqs              # (..., s, hd/2)
    cos = torch.cos(ang)[..., None, :]                      # (..., s, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --- attention ----------------------------------------------------------------

def _gqa_shape(q: torch.Tensor, kv_heads: int):
    b, s, h, d = q.shape
    g = h // kv_heads
    return q.reshape(b, s, kv_heads, g, d), g


def naive_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q (b,s,h,d), k/v (b,s,kv,d).  Materializes (s, s) scores."""
    b, s, h, d = q.shape
    qg, _ = _gqa_shape(q, k.shape[2])
    scale = d ** -0.5
    sc = torch.einsum("bqkgd,bmkd->bkgqm", qg.float(), k.float()) * scale
    if causal:
        mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        sc = torch.where(mask, sc, torch.full_like(sc, -1e30))
    p = torch.softmax(sc, dim=-1)
    o = torch.einsum("bkgqm,bmkd->bqkgd", p, v.float())
    return o.reshape(b, s, h, d).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """(b, s, h, d) attention through the flash kernel: KV heads repeated to
    the query heads (the kernel has no GQA), heads folded into the batch."""
    from repro_torch.kernels import ops as kops
    b, s, h, d = q.shape
    g = h // k.shape[2]
    ke = k.repeat_interleave(g, dim=2) if g > 1 else k
    ve = v.repeat_interleave(g, dim=2) if g > 1 else v
    qs = q.permute(0, 2, 1, 3).reshape(b * h, s, d)
    ks = ke.permute(0, 2, 1, 3).reshape(b * h, s, d)
    vs = ve.permute(0, 2, 1, 3).reshape(b * h, s, d)
    o = kops.flash_attention(qs, ks, vs, causal=causal)
    return o.reshape(b, h, s, d).permute(0, 2, 1, 3)


def attention(q, k, v, impl: str = "chunked", chunk: int = 512,
              causal: bool = True, window: int = 0,
              policy: str | None = None) -> torch.Tensor:
    """Dispatch.  A `window` takes the windowed blockwise attention
    (models/attention.py), whatever `impl` says, as the JAX package routes
    it: its flash kernel has no window.  Otherwise "flash" takes the
    kernel when the dispatch policy says so for this device
    (kernels/dispatch.py) and the blockwise attention otherwise; the
    kernel has no backward and refuses inputs that need a gradient.
    "chunked" is the blockwise attention (online-softmax forward, custom
    backward); "naive" materializes the scores."""
    if window:
        return A.blockwise_attention(q, k, v, chunk, True, window)
    if impl == "naive":
        return naive_attention(q, k, v, causal)
    if impl == "flash":
        from repro_torch.kernels import dispatch
        if dispatch.use_pallas_attention(policy, q.device):
            return flash_attention(q, k, v, causal)
    return A.blockwise_attention(q, k, v, chunk, causal)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     length: torch.Tensor) -> torch.Tensor:
    """Single-token attention against a cache.

    q (b,1,h,d); k/v_cache (b,smax,kv,d); length (b,) current cache fill.
    A data rank's decode rows attend as one device's (`on_whole_rows`:
    the batched products' batch count is rows x kv heads)."""
    return on_whole_rows(_decode_attention, q, k_cache, v_cache, length)


def _decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor,
                      length: torch.Tensor) -> torch.Tensor:
    b, _, h, d = q.shape
    smax = k_cache.shape[1]
    qg, _ = _gqa_shape(q, k_cache.shape[2])                 # (b,1,kv,g,d)
    # a 0-dim CPU tensor of q's dtype: in bf16 the scale rounds before the
    # multiply, as JAX rounds its weakly typed Python scalar
    scale = torch.tensor(d ** -0.5, dtype=q.dtype)
    sc = torch.einsum("bqkgd,bmkd->bkgqm", (qg * scale).float(),
                      k_cache.float())                      # (b,kv,g,1,smax)
    pos = torch.arange(smax, device=q.device)
    valid = pos[None, :] < length[:, None]                  # (b, smax)
    sc = torch.where(valid[:, None, None, None, :], sc,
                     torch.full_like(sc, -1e30))
    p = torch.softmax(sc, dim=-1)
    o = torch.einsum("bkgqm,bmkd->bqkgd", p.to(v_cache.dtype).float(),
                     v_cache.float())
    return o.reshape(b, 1, h, d).to(q.dtype)


def rowwise_cache_update(cache: torch.Tensor, new: torch.Tensor,
                         lengths: torch.Tensor) -> torch.Tensor:
    """Write `new` (b, 1, ...) into `cache` (b, smax, ...) at per-row
    positions `lengths` (b,).  Updates `cache` IN PLACE (and returns it):
    the serving arena owns one cache and a copy per layer per step would
    double its traffic.  Positions clamp to the last row, as the JAX
    package's dynamic_update_slice does for slots decoding past max_len."""
    pos = torch.clamp(lengths, max=cache.shape[1] - 1).long()
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, pos] = new[:, 0].to(cache.dtype)
    return cache


def cache_lengths(cache: dict, batch: int) -> torch.Tensor:
    """cache["length"] — scalar (lock-step) or (b,) (per-slot) — as a
    per-row (b,) int32 vector."""
    return torch.broadcast_to(cache["length"], (batch,)).to(torch.int32)


def last_valid_slice(h: torch.Tensor,
                     true_len: torch.Tensor | None) -> torch.Tensor:
    """h (b, s, d) -> (b, 1, d) hidden state of the last *valid* position."""
    if true_len is None:
        return h[:, -1:]
    idx = torch.clamp(true_len - 1, 0, h.shape[1] - 1).long()
    return h[torch.arange(h.shape[0], device=h.device), idx][:, None]


def tail_window(x: torch.Tensor, true_len: torch.Tensor | None,
                width: int) -> torch.Tensor:
    """Last `width` valid steps of x (b, s, ch) -> (b, width, ch).  Rows
    shorter than `width` are zero-filled on the left, as a causal conv
    state would have seen them."""
    if true_len is None:
        return x[:, -width:]
    xp = F.pad(x, (0, 0, width, 0))
    start = torch.clamp(true_len, 0, x.shape[1]).long()
    idx = start[:, None] + torch.arange(width, device=x.device)[None, :]
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    return xp[rows, idx]


def valid_mask(true_len: torch.Tensor | None, b: int,
               s: int) -> torch.Tensor | None:
    """(b, s) f32 mask of valid (non-pad) positions, or None."""
    if true_len is None:
        return None
    pos = torch.arange(s, device=true_len.device)
    return (pos[None, :] < true_len[:, None]).to(torch.float32)


def prefill_length(true_len: torch.Tensor | None, s: int,
                   device=None) -> torch.Tensor:
    """Cache "length" after prefilling s tokens: per-row (b,) with a
    true_len vector, scalar otherwise."""
    if true_len is None:
        # a fill on the device, not an upload from the host
        return torch.full((), s, dtype=torch.int32, device=device)
    return true_len.to(torch.int32)


# --- MLP ----------------------------------------------------------------------

def silu(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.silu` as the reference rounds it.  In bf16 XLA expands it
    to x * (1 / (1 + exp(-x))) with a bf16 rounding after every op, which
    F.silu (one rounding) misses on about a third of the outputs; in f32
    F.silu is kept."""
    if x.dtype == torch.bfloat16:
        return x * (1 / (1 + torch.exp(-x)))
    return F.silu(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.gelu` (tanh approximation, its default).  In bf16 the
    reference's formula rounds after every op, as `silu` does; in f32 the
    one-op F.gelu is kept."""
    if x.dtype == torch.bfloat16:
        c = torch.tensor(0.7978845608028654, dtype=x.dtype)
        cdf = 0.5 * (1.0 + torch.tanh(c * (x + 0.044715 * (x * x * x))))
        return x * cdf
    return F.gelu(x, approximate="tanh")


def softplus(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.softplus`, i.e. logaddexp(x, 0), in the reference's form:
    max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def swiglu(x: torch.Tensor, w_gate, w_up, w_down,
           spec: MultSpec | None) -> torch.Tensor:
    """Under a mesh the gate and up outputs stay in the rank's column
    blocks through the elementwise SiLU product, and are gathered once
    before w_down."""
    gate = AL.gemm(x, w_gate, spec, gather=False)
    up = AL.gemm(x, w_up, spec, gather=False)
    h = AL.gather_cols(silu(gate) * up, AL.column_split(w_gate))
    return AL.gemm(h, w_down, spec)


def gelu_mlp(x: torch.Tensor, w_up, b_up, w_down, b_down,
             spec: MultSpec | None) -> torch.Tensor:
    """Under a mesh the up projection stays in the rank's column block
    through the GELU, gathered once before w_down (as `swiglu`)."""
    h = AL.dense(x, w_up, b_up, spec, gather=False)
    h = AL.gather_cols(gelu(h), AL.column_split(w_up))
    return AL.dense(h, w_down, b_down, spec)


# --- losses -------------------------------------------------------------------

def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean token cross-entropy in f32.  logits (..., v), labels (...);
    with a mask, the masked mean over max(mask.sum(), 1)."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def maybe_remat(fn, enable: bool):
    """`fn` rematerialised in the backward when `enable`: nothing inside it
    is saved (the reference's `nothing_saveable` policy), only its inputs,
    and the backward reruns it whole.  Without grad the call is plain."""
    if not enable:
        return fn

    def remat(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return torch.utils.checkpoint.checkpoint(
            fn, *args, use_reentrant=False, preserve_rng_state=False)

    return remat
