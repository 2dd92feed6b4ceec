"""Decoder-only transformer LM: the dense path (tinyllama and the other
dense `lm` configs, SwiGLU or GELU MLP) and the vision-cross-attention
variant (llama-3.2-vision): init, prefill with right-padded prompts, and
per-row-length decode against a KV cache.

Parameters keep the JAX package's layer-stacked layout — {"embed",
"final_norm", "layers": {name: (L, ...)}, "lm_head"} with every GEMM
weight (k, n) — so the two packages compute the same function on the same
numbers; the layer scans become Python loops.  For the vision variant the
unit is a superblock of `cross_every` self-attention layers followed by
one gated cross-attention layer: "layers" is stacked (n_super,
cross_every, ...) and "cross" (n_super, ...).  All projections route
through the approximate-GEMM layer (`spec`).  MoE configs raise.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.approx import layers as AL
from repro_torch.configs.base import ModelConfig
from repro_torch.models import common as C

Params = dict[str, Any]

#: Param leaves consumed exclusively through AL.gemm/AL.dense with the
#: model's MultSpec — eligible for the serving weight-plane cache
#: (api.prepare_params).  The embedding is excluded (lookup / tied head).
PREPARED_GEMM_WEIGHTS = frozenset({
    "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
    "ws_gate", "ws_up", "ws_down", "lm_head",
    "xwq", "xwk", "xwv", "xwo",
})


def _check_ported(cfg: ModelConfig) -> None:
    if cfg.is_moe:
        raise NotImplementedError(
            f"{cfg.name}: MoE layers are not ported yet")


def _layer_param_shapes(cfg: ModelConfig) -> dict[str, tuple]:
    d, hd = cfg.d_model, cfg.hd
    h, kv, f = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    shapes = {
        "ln1": (d,), "ln2": (d,),
        "wq": (d, h * hd), "wk": (d, kv * hd), "wv": (d, kv * hd),
        "wo": (h * hd, d),
    }
    if cfg.qkv_bias:
        shapes |= {"bq": (h * hd,), "bk": (kv * hd,), "bv": (kv * hd,)}
    if cfg.mlp_style == "swiglu":
        shapes |= {"w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}
    else:
        shapes |= {"w_up": (d, f), "w_down": (f, d),
                   "mb_up": (f,), "mb_down": (d,)}
    return shapes


def _cross_param_shapes(cfg: ModelConfig) -> dict[str, tuple]:
    d, hd = cfg.d_model, cfg.hd
    h, kv = cfg.n_heads, cfg.n_kv_heads
    return {"xln": (d,), "xln_kv": (d,),
            "xwq": (d, h * hd), "xwk": (d, kv * hd), "xwv": (d, kv * hd),
            "xwo": (h * hd, d), "xgate": (1,)}


def _lead(cfg: ModelConfig) -> tuple[int, ...]:
    """The layer stack's leading axes: (n_layers,), or (n_super,
    cross_every) for a cross-attention model."""
    if cfg.cross_every:
        return (cfg.n_layers // cfg.cross_every, cfg.cross_every)
    return (cfg.n_layers,)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: torch.device) -> Params:
    """Random params with the reference's distributions (normal x
    fan_in^-0.5 for GEMM weights, x 0.02 for the embedding and head, zeros
    for norms, biases and the cross-attention gates), drawn from
    `generator` on `device`."""
    _check_ported(cfg)
    dtype = getattr(torch, cfg.dtype)

    def normal(shape, scale):
        return (torch.randn(shape, generator=generator, device=device,
                            dtype=torch.float32) * scale).to(dtype)

    def stack(shapes, lead):
        out = {}
        for name, shp in sorted(shapes.items()):
            full = (*lead, *shp)
            if name.startswith(("ln", "xln", "b", "mb", "xgate")):
                out[name] = torch.zeros(full, dtype=dtype, device=device)
            else:
                out[name] = normal(full, shp[-2] ** -0.5)
        return out

    # the draw order (layers, cross, embedding, head) fixes the weights a
    # seed gives
    p: Params = {"layers": stack(_layer_param_shapes(cfg), _lead(cfg))}
    if cfg.cross_every:
        p["cross"] = stack(_cross_param_shapes(cfg), _lead(cfg)[:1])
    p["embed"] = normal((cfg.vocab, cfg.d_model), 0.02)
    p["final_norm"] = torch.zeros((cfg.d_model,), dtype=dtype, device=device)
    if not cfg.tie_embeddings:
        p["lm_head"] = normal((cfg.d_model, cfg.vocab), 0.02)
    return p


def _head(params: Params, cfg: ModelConfig):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _qkv(h, lp, cfg: ModelConfig, spec, positions):
    b, s, _ = h.shape
    hd = cfg.hd
    q = AL.dense(h, lp["wq"], lp.get("bq"), spec).reshape(
        b, s, cfg.n_heads, hd)
    k = AL.dense(h, lp["wk"], lp.get("bk"), spec).reshape(
        b, s, cfg.n_kv_heads, hd)
    v = AL.dense(h, lp["wv"], lp.get("bv"), spec).reshape(
        b, s, cfg.n_kv_heads, hd)
    q = C.apply_rope(q, positions, cfg.rope_theta)
    k = C.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _ffn(h, lp, cfg: ModelConfig, spec):
    if "w_gate" in lp:
        return C.swiglu(h, lp["w_gate"], lp["w_up"], lp["w_down"], spec)
    return C.gelu_mlp(h, lp["w_up"], lp["mb_up"], lp["w_down"],
                      lp["mb_down"], spec)


def cross_block(h, xp, img, cfg: ModelConfig, spec):
    """Gated cross-attention to image embeddings (llama-3.2-vision
    style): K and V are computed from `img` (b, n_img, d) at every call,
    and the output is scaled by tanh(xgate)."""
    from repro_torch.models.attention import blockwise_attention
    x = C.rmsnorm(h, xp["xln"])
    b, s, _ = x.shape
    hd = cfg.hd
    q = AL.gemm(x, xp["xwq"], spec).reshape(b, s, cfg.n_heads, hd)
    ikv = C.rmsnorm(img, xp["xln_kv"])
    k = AL.gemm(ikv, xp["xwk"], spec).reshape(b, -1, cfg.n_kv_heads, hd)
    v = AL.gemm(ikv, xp["xwv"], spec).reshape(b, -1, cfg.n_kv_heads, hd)
    if img.shape[1] * s <= 1 << 20:
        attn = C.naive_attention(q, k, v, causal=False)
    else:
        attn = blockwise_attention(q, k, v, cfg.attn_chunk, False, 0)
    o = AL.gemm(attn.reshape(b, s, -1), xp["xwo"], spec)
    return h + torch.tanh(xp["xgate"]).to(h.dtype) * o


def _image(img_embeds, cfg: ModelConfig, b: int, like: torch.Tensor):
    """The image embeddings a cross-attention model attends to: zeros
    when the request carries none, as in the reference."""
    if img_embeds is not None:
        return img_embeds
    return torch.zeros((b, cfg.n_img_tokens, cfg.d_model), dtype=like.dtype,
                       device=like.device)


def _blocks(params: Params, cfg: ModelConfig):
    """Every self-attention block in order, as (its cache index, its
    params, the superblock's cross params after it or None)."""
    if not cfg.cross_every:
        for i in range(cfg.n_layers):
            yield (i,), C.block_params(params["layers"], i), None
        return
    for i in range(_lead(cfg)[0]):
        for j in range(cfg.cross_every):
            last = j == cfg.cross_every - 1
            yield ((i, j), C.block_params(params["layers"], i, j),
                   C.block_params(params["cross"], i) if last else None)


# --------------------------------------------------------------------------
# serving: prefill + decode with KV cache
# --------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: torch.device, dtype=None) -> dict:
    _check_ported(cfg)
    dtype = dtype or getattr(torch, cfg.dtype)
    shape = (*_lead(cfg), batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "length": torch.zeros((), dtype=torch.int32, device=device),
    }


def _decode_block(h, lp, ck, cv, lengths, cfg: ModelConfig, spec):
    """Single-token block against cache slices ck/cv (b, smax, kv, hd),
    which it updates in place; `lengths` is per-row (b,)."""
    b = h.shape[0]
    x = C.rmsnorm(h, lp["ln1"])
    q, k, v = _qkv(x, lp, cfg, spec, lengths[:, None])
    C.rowwise_cache_update(ck, k, lengths)
    C.rowwise_cache_update(cv, v, lengths)
    attn = C.decode_attention(q, ck, cv, lengths + 1)
    h = h + AL.dense(attn.reshape(b, 1, -1), lp["wo"], None, spec)
    x = C.rmsnorm(h, lp["ln2"])
    return h + _ffn(x, lp, cfg, spec)


def decode_step(params: Params, cache: dict, tokens: torch.Tensor,
                cfg: ModelConfig, spec=None,
                img_embeds: torch.Tensor | None = None) -> tuple:
    """tokens (b, 1) -> (logits (b, 1, v), cache).

    cache["length"] may be a scalar (lock-step batch) or per-row (b,)
    (continuous batching).  The K/V buffers are updated in place; the
    returned dict shares them and carries length + 1.  A cross-attention
    model attends to `img_embeds` (b, n_img, d), zeros when None."""
    _check_ported(cfg)
    b = tokens.shape[0]
    h = AL.embed(tokens, params["embed"])
    length = C.cache_lengths(cache, b)
    img = _image(img_embeds, cfg, b, h) if cfg.cross_every else None
    for idx, lp, xp in _blocks(params, cfg):
        h = _decode_block(h, lp, cache["k"][idx], cache["v"][idx], length,
                          cfg, spec)
        if xp is not None:
            h = cross_block(h, xp, img, cfg, spec)
    h = C.rmsnorm(h, params["final_norm"])
    logits = AL.gemm(h, _head(params, cfg), spec)
    return logits, {"k": cache["k"], "v": cache["v"],
                    "length": cache["length"] + 1}


def prefill(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
            spec=None, max_len: int | None = None,
            img_embeds: torch.Tensor | None = None,
            true_len: torch.Tensor | None = None) -> tuple:
    """tokens (b, s) -> (logits of the last valid position (b, v), cache).

    `true_len` (b,) marks right-padded prompts: logits come from position
    true_len - 1 and the cache length is per-row.  A cross-attention
    model attends to `img_embeds` (b, n_img, d), zeros when None."""
    _check_ported(cfg)
    b, s = tokens.shape
    max_len = max_len or s
    h = AL.embed(tokens, params["embed"])
    positions = torch.arange(s, device=tokens.device)[None, :]
    policy = spec.policy if spec is not None else None
    cache = init_cache(cfg, b, max_len, tokens.device)
    img = _image(img_embeds, cfg, b, h) if cfg.cross_every else None
    for idx, lp, xp in _blocks(params, cfg):
        x = C.rmsnorm(h, lp["ln1"])
        q, k, v = _qkv(x, lp, cfg, spec, positions)
        attn = C.attention(q, k, v, impl=cfg.attn_impl, chunk=cfg.attn_chunk,
                           policy=policy)
        h = h + AL.dense(attn.reshape(b, s, -1), lp["wo"], None, spec)
        x = C.rmsnorm(h, lp["ln2"])
        h = h + _ffn(x, lp, cfg, spec)
        cache["k"][idx][:, :s] = k
        cache["v"][idx][:, :s] = v
        if xp is not None:
            h = cross_block(h, xp, img, cfg, spec)
    h = C.rmsnorm(C.last_valid_slice(h, true_len), params["final_norm"])
    logits = AL.gemm(h, _head(params, cfg), spec)[:, 0]
    cache["length"] = C.prefill_length(true_len, s, tokens.device)
    return logits, cache
