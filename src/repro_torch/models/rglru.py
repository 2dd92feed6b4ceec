"""RecurrentGemma / Griffin hybrid: RG-LRU recurrent blocks and local
sliding-window attention in the repeating pattern (recurrent, recurrent,
local attention), the counterpart of the JAX package's
`repro.models.rglru` (arXiv:2402.19427).

The RG-LRU h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t) runs as a
log-depth doubling scan in prefill (`_rglru_scan`, the same pairwise
recursion `jax.lax.associative_scan` takes, so the products and sums
happen in the reference's order) and as one fused update per token in
decode.  Decode keeps an O(window) ring of K/V for the attention blocks
and O(1) state for the recurrences.

Projections route through the approximate GEMM (`spec`), except the
RG-LRU gate projections `w_rg` / `w_in`, which stay exact (spec-less
`AL.gemm`, a plain float product) as in the reference.  The attention
blocks' windowed attention is `models/attention.py`'s plain forward: the
reference's flash kernel has no window.

Stacked recurrent weights are (n_super, 2, ...): superblock i's two
recurrent blocks are `[i][0]` and `[i][1]` (`PreparedWeight.layer` twice).
Decode writes each ring's new K/V row in place, as the dense family
writes its K/V; every recurrent state it returns is a fresh tensor.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.approx import layers as AL
from repro_torch.configs.base import ModelConfig
from repro_torch.models import common as C
from repro_torch.models.attention import blockwise_attention
from repro_torch.models.mamba2 import _causal_conv

Params = dict[str, Any]
C_EXPONENT = 8.0  # RG-LRU exponent scale

#: Param leaves of the serving weight-plane cache (api.prepare_params).
#: The RG-LRU gate projections w_rg / w_in are not listed: they run exact,
#: and a quantized copy would change their math.  Conv taps and lam are
#: read directly.
PREPARED_GEMM_WEIGHTS = frozenset({
    "w_x", "w_gate_br", "w_out", "m_gate", "m_up", "m_down",
    "wq", "wk", "wv", "wo", "lm_head",
})


def _pattern(cfg: ModelConfig) -> tuple[int, int]:
    """(n_super, n_tail_recurrent): layers = n_super * (2 recurrent + 1
    attention) + tail recurrent blocks."""
    n_super = cfg.n_layers // 3
    return n_super, cfg.n_layers - 3 * n_super


def _rec_shapes(cfg: ModelConfig) -> dict[str, tuple]:
    d = cfg.d_model
    w = cfg.lru_width or d
    return {
        "ln": (d,),
        "w_x": (d, w), "w_gate_br": (d, w),
        "conv_w": (4, w), "conv_b": (w,),
        "w_rg": (w, w), "w_in": (w, w),     # recurrence / input gates
        "lam": (w,),                        # a = sigmoid(lam)
        "w_out": (w, d),
        "mln": (d,), "m_gate": (d, cfg.d_ff), "m_up": (d, cfg.d_ff),
        "m_down": (cfg.d_ff, d),
    }


def _attn_shapes(cfg: ModelConfig) -> dict[str, tuple]:
    d, hd = cfg.d_model, cfg.hd
    return {
        "ln": (d,),
        "wq": (d, cfg.n_heads * hd), "wk": (d, cfg.n_kv_heads * hd),
        "wv": (d, cfg.n_kv_heads * hd), "wo": (cfg.n_heads * hd, d),
        "mln": (d,), "m_gate": (d, cfg.d_ff), "m_up": (d, cfg.d_ff),
        "m_down": (cfg.d_ff, d),
    }


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: torch.device) -> Params:
    """Random params with the reference's distributions, drawn from
    `generator` on `device`; `lam` is f32 whatever `cfg.dtype` is."""
    dtype = getattr(torch, cfg.dtype)
    n_super, tail = _pattern(cfg)

    def init_block(shapes, stack):
        out = {}
        for name, shp in sorted(shapes.items()):
            full = (*stack, *shp)
            if name in ("ln", "mln", "conv_b"):
                out[name] = torch.zeros(full, dtype=dtype, device=device)
            elif name == "lam":
                # a^c ~ U(0.9, 0.999), lam = logit(u)
                u = torch.rand(full, generator=generator, device=device,
                               dtype=torch.float32) * 0.099 + 0.9
                out[name] = torch.log(u / (1 - u))
            else:
                scale = (shp[-2] if len(shp) >= 2 else 1) ** -0.5
                out[name] = (torch.randn(full, generator=generator,
                                         device=device, dtype=torch.float32)
                             * scale).to(dtype)
        return out

    p: Params = {
        "embed": (torch.randn((cfg.vocab, cfg.d_model), generator=generator,
                              device=device, dtype=torch.float32)
                  * 0.02).to(dtype),
        "rec": init_block(_rec_shapes(cfg), (n_super, 2)),
        "attn": init_block(_attn_shapes(cfg), (n_super,)),
        "final_norm": torch.zeros((cfg.d_model,), dtype=dtype, device=device),
        "lm_head": (torch.randn((cfg.d_model, cfg.vocab), generator=generator,
                                device=device, dtype=torch.float32)
                    * 0.02).to(dtype),
    }
    if tail:
        p["rec_tail"] = init_block(_rec_shapes(cfg), (tail,))
    return p


# --- RG-LRU core --------------------------------------------------------------

def _scan_pairs(a: torch.Tensor, x: torch.Tensor):
    """`jax.lax.associative_scan` of (a, x) along axis 1 under the combine
    (a1, x1), (a2, x2) -> (a1 * a2, x1 * a2 + x2): the same recursion
    (pairs reduced, the half-length scan, then the even positions), so the
    same products and sums in the same order.  Each x1 * a2 + x2 is one
    fused multiply-add (`addcmul`), as XLA contracts it.  log2(s)
    levels."""
    n = a.shape[1]
    if n < 2:
        return a, x
    a_odd, x_odd = _scan_pairs(
        a[:, 0:-1:2] * a[:, 1::2],
        torch.addcmul(x[:, 1::2], x[:, 0:-1:2], a[:, 1::2]))
    if n % 2 == 0:
        a_odd_, x_odd_ = a_odd[:, :-1], x_odd[:, :-1]
    else:
        a_odd_, x_odd_ = a_odd, x_odd
    a2, x2 = a[:, 2::2], x[:, 2::2]
    a_even = torch.cat([a[:, :1], a_odd_ * a2], dim=1)
    x_even = torch.cat([x[:, :1], torch.addcmul(x2, x_odd_, a2)], dim=1)
    a_out, x_out = torch.empty_like(a), torch.empty_like(x)
    a_out[:, 0::2], a_out[:, 1::2] = a_even, a_odd
    x_out[:, 0::2], x_out[:, 1::2] = x_even, x_odd
    return a_out, x_out


def _rglru_scan(x: torch.Tensor, a: torch.Tensor,
                init: torch.Tensor | None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """h_t = a_t * h_{t-1} + x_t.  x, a (b, s, w) -> (h, h[:, -1])."""
    if init is not None:
        # fold the initial state into the first step
        x = torch.cat([torch.addcmul(x[:, :1], a[:, :1], init[:, None]),
                       x[:, 1:]], dim=1)
    _, h = _scan_pairs(a, x)
    return h, h[:, -1]


def _gates(xf: torch.Tensor, rp: Params):
    """(a, sqrt(1 - a^2) * (i * x)) of the RG-LRU at f32 inputs xf."""
    r = torch.sigmoid(AL.gemm(xf, rp["w_rg"]))
    i = torch.sigmoid(AL.gemm(xf, rp["w_in"]))
    a = torch.exp(-C_EXPONENT * r * C.softplus(rp["lam"]))   # log a <= 0
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * xf)
    return a, gated


def rglru(x: torch.Tensor, rp: Params, init_state: torch.Tensor | None = None,
          mask: torch.Tensor | None = None):
    """RG-LRU over a sequence.  x (b, s, w), the post-conv branch input.
    `mask` (b, s) marks valid positions: pads get a = 1 and zero input,
    identity updates, so the carried state is the state after each row's
    last valid token."""
    a, gated = _gates(x.float(), rp)
    if mask is not None:
        a = torch.where(mask[..., None] > 0, a, torch.ones_like(a))
        gated = gated * mask[..., None]
    h, last = _rglru_scan(gated, a, init_state)
    return h.to(x.dtype), last


def _recurrent_block(hstate, rp, cfg: ModelConfig, spec, conv_state=None,
                     lru_state=None, decode=False, true_len=None):
    x = C.rmsnorm(hstate, rp["ln"])
    branch = AL.gemm(x, rp["w_x"], spec)
    gate = C.gelu(AL.gemm(x, rp["w_gate_br"], spec))
    if decode:
        window = torch.cat([conv_state, branch], dim=1)
        conv = ((window.float() * rp["conv_w"].float()[None]).sum(1)
                + rp["conv_b"].float())[:, None].to(hstate.dtype)
        new_conv = window[:, 1:]
        xf = conv[:, 0].float()
        a, gated = _gates(xf, rp)
        new_lru = a * lru_state + gated
        lru_out = new_lru[:, None].to(hstate.dtype)
    else:
        conv = _causal_conv(branch, rp["conv_w"], rp["conv_b"])
        mask = C.valid_mask(true_len, *hstate.shape[:2])
        lru_out, new_lru = rglru(conv, rp, lru_state, mask)
        new_conv = C.tail_window(branch, true_len, 3)
    hstate = hstate + AL.gemm(lru_out * gate, rp["w_out"], spec)
    x = C.rmsnorm(hstate, rp["mln"])
    return hstate + _geglu(x, rp, spec), new_conv, new_lru


def _geglu(x, p, spec):
    g = C.gelu(AL.gemm(x, p["m_gate"], spec))
    u = AL.gemm(x, p["m_up"], spec)
    return AL.gemm(g * u, p["m_down"], spec)


def _qkv(x, ap, cfg: ModelConfig, spec, positions):
    b, s, _ = x.shape
    hd = cfg.hd
    q = AL.gemm(x, ap["wq"], spec).reshape(b, s, cfg.n_heads, hd)
    k = AL.gemm(x, ap["wk"], spec).reshape(b, s, cfg.n_kv_heads, hd)
    v = AL.gemm(x, ap["wv"], spec).reshape(b, s, cfg.n_kv_heads, hd)
    return (C.apply_rope(q, positions, cfg.rope_theta),
            C.apply_rope(k, positions, cfg.rope_theta), v)


def _attention_block(hstate, ap, cfg: ModelConfig, spec, positions):
    """The local-attention block over a full sequence -> (h, k, v)."""
    b, s, _ = hstate.shape
    q, k, v = _qkv(C.rmsnorm(hstate, ap["ln"]), ap, cfg, spec, positions)
    attn = blockwise_attention(q, k, v, cfg.attn_chunk, True, cfg.window)
    hstate = hstate + AL.gemm(attn.reshape(b, s, -1), ap["wo"], spec)
    return hstate + _geglu(C.rmsnorm(hstate, ap["mln"]), ap, spec), k, v


def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
            spec=None, **_) -> tuple:
    """tokens (b, s) -> (logits (b, s, v), 0.0).  Under `cfg.remat` each
    superblock's recurrent and attention blocks rerun in the backward;
    the tail's recurrent blocks do not, as in the reference."""
    b, s = tokens.shape
    n_super, tail = _pattern(cfg)
    h = AL.embed(tokens, params["embed"])
    positions = torch.arange(s, device=tokens.device)[None, :]
    rec = C.maybe_remat(
        lambda hh, rp: _recurrent_block(hh, rp, cfg, spec)[0], cfg.remat)
    att = C.maybe_remat(
        lambda hh, ap: _attention_block(hh, ap, cfg, spec, positions)[0],
        cfg.remat)
    if n_super:
        recs = C.unstack(params["rec"], 2)
        attns = C.unstack(params["attn"], 1)
    for i in range(n_super):
        for j in range(2):
            h = rec(h, C.block_params(recs, i, j))
        h = att(h, C.block_params(attns, i))
    if tail:
        tails = C.unstack(params["rec_tail"], 1)
    for i in range(tail):
        h = _recurrent_block(h, C.block_params(tails, i), cfg, spec)[0]
    h = C.rmsnorm(h, params["final_norm"])
    return AL.gemm(h, params["lm_head"], spec), 0.0


# --- serving -------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: torch.device, dtype=None) -> dict:
    """O(window) attention rings and O(1) recurrent state."""
    dtype = dtype or getattr(torch, cfg.dtype)
    n_super, tail = _pattern(cfg)
    w = cfg.lru_width or cfg.d_model
    ring = (n_super, batch, cfg.window, cfg.n_kv_heads, cfg.hd)
    f32 = torch.float32
    cache = {
        "rec_conv": torch.zeros((n_super, 2, batch, 3, w), dtype=dtype,
                                device=device),
        "rec_lru": torch.zeros((n_super, 2, batch, w), dtype=f32,
                               device=device),
        "att_k": torch.zeros(ring, dtype=dtype, device=device),
        "att_v": torch.zeros(ring, dtype=dtype, device=device),
        "length": torch.zeros((), dtype=torch.int32, device=device),
    }
    if tail:
        cache["tail_conv"] = torch.zeros((tail, batch, 3, w), dtype=dtype,
                                         device=device)
        cache["tail_lru"] = torch.zeros((tail, batch, w), dtype=f32,
                                        device=device)
    return cache


def _attn_decode(hh, ap, ck, cv, length, cfg: ModelConfig, spec):
    """Single-token attention block against one layer's rings ck / cv
    (b, window, kv, hd), which take the new row in place at length %
    window."""
    b = hh.shape[0]
    win = cfg.window
    x = C.rmsnorm(hh, ap["ln"])
    q, k, v = _qkv(x, ap, cfg, spec, length[:, None])
    slot = torch.remainder(length, win)
    C.rowwise_cache_update(ck, k, slot)
    C.rowwise_cache_update(cv, v, slot)
    # every slot is valid once length >= window
    attn = C.decode_attention(q, ck, cv, torch.clamp(length + 1, max=win))
    hh = hh + AL.gemm(attn.reshape(b, 1, -1), ap["wo"], spec)
    x = C.rmsnorm(hh, ap["mln"])
    return hh + _geglu(x, ap, spec)


def decode_step(params: Params, cache: dict, tokens: torch.Tensor,
                cfg: ModelConfig, spec=None) -> tuple:
    """tokens (b, 1) -> (logits (b, 1, v), cache).  The rings take the new
    K/V row in place and the returned dict shares them; the recurrent
    states come back as fresh tensors and length + 1."""
    b = tokens.shape[0]
    n_super, tail = _pattern(cfg)
    h = AL.embed(tokens, params["embed"])
    length = C.cache_lengths(cache, b)
    rc, rl = [], []
    for i in range(n_super):
        conv2, lru2 = [], []
        for j in range(2):
            h, nc, nl = _recurrent_block(
                h, C.block_params(params["rec"], i, j), cfg, spec,
                cache["rec_conv"][i, j], cache["rec_lru"][i, j],
                decode=True)
            conv2.append(nc)
            lru2.append(nl)
        rc.append(torch.stack(conv2))
        rl.append(torch.stack(lru2))
        h = _attn_decode(h, C.block_params(params["attn"], i), cache["att_k"][i],
                         cache["att_v"][i], length, cfg, spec)
    new = dict(cache, length=cache["length"] + 1)
    if n_super:
        new["rec_conv"], new["rec_lru"] = torch.stack(rc), torch.stack(rl)
    if tail:
        tc, tl = [], []
        for i in range(tail):
            h, nc, nl = _recurrent_block(
                h, C.block_params(params["rec_tail"], i), cfg, spec,
                cache["tail_conv"][i], cache["tail_lru"][i], decode=True)
            tc.append(nc)
            tl.append(nl)
        new["tail_conv"], new["tail_lru"] = torch.stack(tc), torch.stack(tl)
    h = C.rmsnorm(h, params["final_norm"])
    return AL.gemm(h, params["lm_head"], spec), new


def _rolling_slots(s: int, win: int, device) -> tuple:
    """Ring slot -> absolute position after s prefilled tokens, and which
    slots hold one."""
    slots = torch.arange(win, device=device)
    pos = (s - 1) - torch.remainder((s - 1) - slots, win)
    return pos, (pos >= 0) & (pos > s - 1 - win)


def prefill(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
            spec=None, max_len: int | None = None,
            true_len: torch.Tensor | None = None) -> tuple:
    """The full-sequence pass, capturing the decode state: final RG-LRU
    states, conv tails and the last `window` K/V in ring-slot order, so
    decode continues at absolute position s.  With `true_len` (b,) every
    piece is taken at each row's own end."""
    b, s = tokens.shape
    n_super, tail = _pattern(cfg)
    dtype = getattr(torch, cfg.dtype)
    dev = tokens.device
    h = AL.embed(tokens, params["embed"])
    positions = torch.arange(s, device=dev)[None, :]
    win = cfg.window
    if true_len is None:
        pos_map, valid = _rolling_slots(s, win, dev)
        pos_map, valid = pos_map[None], valid[None]
    else:
        last = true_len[:, None].long() - 1                     # (b, 1)
        pos_map = last - torch.remainder(
            last - torch.arange(win, device=dev)[None], win)
        valid = (pos_map >= 0) & (pos_map > last - win)
    rows = torch.arange(b, device=dev)[:, None]
    pos_c = torch.clamp(pos_map, 0, s - 1).expand(b, win)
    keep = valid.expand(b, win)[..., None, None]

    def ring(t):
        return torch.where(keep, t[rows, pos_c], torch.zeros(
            (), dtype=t.dtype, device=dev)).to(dtype)

    rc, rl, ck, cv = [], [], [], []
    for i in range(n_super):
        conv2, lru2 = [], []
        for j in range(2):
            h, tail_, last_ = _recurrent_block(
                h, C.block_params(params["rec"], i, j), cfg, spec,
                true_len=true_len)
            conv2.append(tail_)
            lru2.append(last_)
        rc.append(torch.stack(conv2))
        rl.append(torch.stack(lru2))
        h, k, v = _attention_block(h, C.block_params(params["attn"], i),
                                   cfg, spec, positions)
        ck.append(ring(k))
        cv.append(ring(v))
    cache = init_cache(cfg, b, s, dev) if not n_super else {
        "rec_conv": torch.stack(rc).to(dtype), "rec_lru": torch.stack(rl),
        "att_k": torch.stack(ck), "att_v": torch.stack(cv)}
    cache["length"] = C.prefill_length(true_len, s, dev)
    if tail:
        tc, tl = [], []
        for i in range(tail):
            h, tail_, last_ = _recurrent_block(
                h, C.block_params(params["rec_tail"], i), cfg, spec,
                true_len=true_len)
            tc.append(tail_)
            tl.append(last_)
        cache["tail_conv"] = torch.stack(tc).to(dtype)
        cache["tail_lru"] = torch.stack(tl)
    h = C.rmsnorm(C.last_valid_slice(h, true_len), params["final_norm"])
    return AL.gemm(h, params["lm_head"], spec)[:, 0], cache
