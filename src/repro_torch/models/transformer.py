"""Decoder-only transformer LM, dense path (tinyllama and the other dense
`lm` configs): init, prefill with right-padded prompts, and per-row-length
decode against a KV cache.

Parameters keep the JAX package's layer-stacked layout — {"embed",
"final_norm", "layers": {name: (L, ...)}, "lm_head"} with every GEMM
weight (k, n) — so the two packages compute the same function on the same
numbers; the layer scans become Python loops.  All projections route
through the approximate-GEMM layer (`spec`).  MoE and cross-attention
configs raise.
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


def _check_dense(cfg: ModelConfig) -> None:
    if cfg.is_moe or cfg.cross_every:
        raise NotImplementedError(
            f"{cfg.name}: MoE and cross-attention layers are not ported yet")
    if cfg.mlp_style != "swiglu":
        raise NotImplementedError(f"{cfg.name}: only the swiglu MLP is "
                                  "ported")


def _layer_param_shapes(cfg: ModelConfig) -> dict[str, tuple]:
    d, hd = cfg.d_model, cfg.hd
    h, kv, f = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    shapes = {
        "ln1": (d,), "ln2": (d,),
        "wq": (d, h * hd), "wk": (d, kv * hd), "wv": (d, kv * hd),
        "wo": (h * hd, d),
        "w_gate": (d, f), "w_up": (d, f), "w_down": (f, d),
    }
    if cfg.qkv_bias:
        shapes |= {"bq": (h * hd,), "bk": (kv * hd,), "bv": (kv * hd,)}
    return shapes


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: torch.device) -> Params:
    """Random params with the reference's distributions (normal x
    fan_in^-0.5 for GEMM weights, x 0.02 for the embedding and head, zeros
    for norms and biases), drawn from `generator` on `device`."""
    _check_dense(cfg)
    dtype = getattr(torch, cfg.dtype)

    def normal(shape, scale):
        return (torch.randn(shape, generator=generator, device=device,
                            dtype=torch.float32) * scale).to(dtype)

    layers = {}
    for name, shp in sorted(_layer_param_shapes(cfg).items()):
        full = (cfg.n_layers, *shp)
        if name.startswith(("ln", "b")):
            layers[name] = torch.zeros(full, dtype=dtype, device=device)
        else:
            layers[name] = normal(full, shp[-2] ** -0.5)
    p: Params = {
        "embed": normal((cfg.vocab, cfg.d_model), 0.02),
        "final_norm": torch.zeros((cfg.d_model,), dtype=dtype, device=device),
        "layers": layers,
    }
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
    return C.swiglu(h, lp["w_gate"], lp["w_up"], lp["w_down"], spec)


# --------------------------------------------------------------------------
# serving: prefill + decode with KV cache
# --------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: torch.device, dtype=None) -> dict:
    _check_dense(cfg)
    dtype = dtype or getattr(torch, cfg.dtype)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
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
                cfg: ModelConfig, spec=None) -> tuple:
    """tokens (b, 1) -> (logits (b, 1, v), cache).

    cache["length"] may be a scalar (lock-step batch) or per-row (b,)
    (continuous batching).  The K/V buffers are updated in place; the
    returned dict shares them and carries length + 1."""
    _check_dense(cfg)
    b = tokens.shape[0]
    h = AL.embed(tokens, params["embed"])
    length = C.cache_lengths(cache, b)
    for i in range(cfg.n_layers):
        h = _decode_block(h, C.block_params(params["layers"], i), cache["k"][i],
                          cache["v"][i], length, cfg, spec)
    h = C.rmsnorm(h, params["final_norm"])
    logits = AL.gemm(h, _head(params, cfg), spec)
    return logits, {"k": cache["k"], "v": cache["v"],
                    "length": cache["length"] + 1}


def prefill(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
            spec=None, max_len: int | None = None,
            true_len: torch.Tensor | None = None) -> tuple:
    """tokens (b, s) -> (logits of the last valid position (b, v), cache).

    `true_len` (b,) marks right-padded prompts: logits come from position
    true_len - 1 and the cache length is per-row."""
    _check_dense(cfg)
    b, s = tokens.shape
    max_len = max_len or s
    dtype = getattr(torch, cfg.dtype)
    h = AL.embed(tokens, params["embed"])
    positions = torch.arange(s, device=tokens.device)[None, :]
    policy = spec.policy if spec is not None else None
    shape = (cfg.n_layers, b, max_len, cfg.n_kv_heads, cfg.hd)
    ks = torch.zeros(shape, dtype=dtype, device=tokens.device)
    vs = torch.zeros(shape, dtype=dtype, device=tokens.device)
    for i in range(cfg.n_layers):
        lp = C.block_params(params["layers"], i)
        x = C.rmsnorm(h, lp["ln1"])
        q, k, v = _qkv(x, lp, cfg, spec, positions)
        attn = C.attention(q, k, v, impl=cfg.attn_impl, chunk=cfg.attn_chunk,
                           policy=policy)
        h = h + AL.dense(attn.reshape(b, s, -1), lp["wo"], None, spec)
        x = C.rmsnorm(h, lp["ln2"])
        h = h + _ffn(x, lp, cfg, spec)
        ks[i, :, :s] = k
        vs[i, :, :s] = v
    h = C.rmsnorm(C.last_valid_slice(h, true_len), params["final_norm"])
    logits = AL.gemm(h, _head(params, cfg), spec)[:, 0]
    cache = {"k": ks, "v": vs,
             "length": C.prefill_length(true_len, s, tokens.device)}
    return logits, cache
