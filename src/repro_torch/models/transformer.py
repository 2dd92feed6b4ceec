"""Decoder-only transformer LM: the dense path (tinyllama and the other
dense `lm` configs, SwiGLU or GELU MLP) and the vision-cross-attention
variant (llama-3.2-vision): init, the training forward, prefill with
right-padded prompts, and per-row-length decode against a KV cache.

Parameters keep the JAX package's layer-stacked layout — {"embed",
"final_norm", "layers": {name: (L, ...)}, "lm_head"} with every GEMM
weight (k, n) — so the two packages compute the same function on the same
numbers; the layer scans become Python loops.  For the vision variant the
unit is a superblock of `cross_every` self-attention layers followed by
one gated cross-attention layer: "layers" is stacked (n_super,
cross_every, ...) and "cross" (n_super, ...).  The MoE configs route
their FFN through `models/moe.py`: in every layer (grok-1: "layers"
stacked (n_layers, ...) with the router and the expert stacks we_*
(n_layers, e, k, n)), or in the last layer of each superblock of
`moe_every` (llama4-maverick: "layers" stacked (n_super, moe_every - 1,
...) dense, "moe" (n_super, ...) with a shared expert ws_*), the cache
then (n_super, moe_every, b, max_len, kv, hd).  All projections route
through the approximate-GEMM layer (`spec`).

Under a mesh (`sharding.ctx`) whose model axis divides `n_kv_heads` (and
so `n_heads`), self-attention runs on the rank's heads: the q/k/v GEMMs
keep the rank's column blocks, which are whole heads (its query heads
map to its kv heads), the K/V cache holds those heads only
(`sharding.rules.cache_pspec`), the attention runs them among zero
heads of the whole count (`_whole_heads`: one device's shapes, so one
device's bits), and its output is gathered before `wo`.  Otherwise q/k/v are gathered and attention is replicated
(the reference's divisibility drop).  Cross-attention stays replicated.
"""

from __future__ import annotations

import functools
from typing import Any

import torch

from repro_torch.approx import layers as AL
from repro_torch.configs.base import ModelConfig
from repro_torch.models import common as C
from repro_torch.models.moe import moe_ffn
from repro_torch.sharding import ctx, rules

Params = dict[str, Any]

#: Param leaves consumed exclusively through AL.gemm/AL.dense with the
#: model's MultSpec — eligible for the serving weight-plane cache
#: (api.prepare_params).  The embedding is excluded (lookup / tied head),
#: and so is the MoE router (exact f32 control logic).  The expert stacks
#: we_* are prepared per expert matrix, where the reference quantizes
#: them on every call: the same int8 codes and scales, so the same bits.
PREPARED_GEMM_WEIGHTS = frozenset({
    "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
    "ws_gate", "ws_up", "ws_down", "lm_head",
    "xwq", "xwk", "xwv", "xwo",
    "we_gate", "we_up", "we_down",
})


def _layer_param_shapes(cfg: ModelConfig, moe: bool | None = None
                        ) -> dict[str, tuple]:
    """moe=None: follow cfg.is_moe for every layer; True/False pin the
    layer kind (for interleaved dense/MoE stacks)."""
    d, hd = cfg.d_model, cfg.hd
    h, kv, f = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    moe = cfg.is_moe if moe is None else moe
    shapes = {
        "ln1": (d,), "ln2": (d,),
        "wq": (d, h * hd), "wk": (d, kv * hd), "wv": (d, kv * hd),
        "wo": (h * hd, d),
    }
    if cfg.qkv_bias:
        shapes |= {"bq": (h * hd,), "bk": (kv * hd,), "bv": (kv * hd,)}
    if moe:
        e = cfg.n_experts
        shapes |= {"router": (d, e), "we_gate": (e, d, f),
                   "we_up": (e, d, f), "we_down": (e, f, d)}
        if cfg.shared_expert:
            shapes |= {"ws_gate": (d, f), "ws_up": (d, f), "ws_down": (f, d)}
    else:
        fd = (cfg.d_ff_dense or f) if cfg.is_moe else f
        if cfg.mlp_style == "swiglu":
            shapes |= {"w_gate": (d, fd), "w_up": (d, fd), "w_down": (fd, d)}
        else:
            shapes |= {"w_up": (d, fd), "w_down": (fd, d),
                       "mb_up": (fd,), "mb_down": (d,)}
    return shapes


def _cross_param_shapes(cfg: ModelConfig) -> dict[str, tuple]:
    d, hd = cfg.d_model, cfg.hd
    h, kv = cfg.n_heads, cfg.n_kv_heads
    return {"xln": (d,), "xln_kv": (d,),
            "xwq": (d, h * hd), "xwk": (d, kv * hd), "xwv": (d, kv * hd),
            "xwo": (h * hd, d), "xgate": (1,)}


def _interleaved(cfg: ModelConfig) -> bool:
    """Dense and MoE layers interleaved: superblocks of moe_every - 1
    dense layers and one MoE layer."""
    return cfg.is_moe and cfg.moe_every > 1


def _lead(cfg: ModelConfig) -> tuple[int, ...]:
    """The cache's (and, but for an interleaved MoE model, the layer
    stack's) leading axes: (n_layers,), (n_super, cross_every) for a
    cross-attention model, (n_super, moe_every) for an interleaved one."""
    if cfg.cross_every:
        return (cfg.n_layers // cfg.cross_every, cfg.cross_every)
    if _interleaved(cfg):
        return (cfg.n_layers // cfg.moe_every, cfg.moe_every)
    return (cfg.n_layers,)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: torch.device) -> Params:
    """Random params with the reference's distributions (normal x
    fan_in^-0.5 for GEMM weights, x 0.02 for the embedding and head, zeros
    for norms, biases and the cross-attention gates), drawn from
    `generator` on `device`.  The draw order (the layer stack, then the
    cross-attention stack or the interleaved MoE stack, the embedding and
    the head; within a stack, its leaves by name) fixes the weights a
    seed gives."""
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

    if _interleaved(cfg):
        n_super, m = _lead(cfg)
        p: Params = {
            "layers": stack(_layer_param_shapes(cfg, moe=False),
                            (n_super, m - 1)),
            "moe": stack(_layer_param_shapes(cfg, moe=True), (n_super,))}
    else:
        p = {"layers": stack(_layer_param_shapes(cfg), _lead(cfg))}
    if cfg.cross_every:
        p["cross"] = stack(_cross_param_shapes(cfg), _lead(cfg)[:1])
    p["embed"] = normal((cfg.vocab, cfg.d_model), 0.02)
    p["final_norm"] = torch.zeros((cfg.d_model,), dtype=dtype, device=device)
    if not cfg.tie_embeddings:
        p["lm_head"] = normal((cfg.d_model, cfg.vocab), 0.02)
    return p


def _head(params: Params, cfg: ModelConfig):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def head_split(cfg: ModelConfig) -> int:
    """The ranks self-attention's heads split over under the active mesh:
    its model-axis size where `cache_pspec` puts the kv-head dim of the
    K/V cache on "model", else 1 (attention replicated)."""
    mesh = ctx.active_mesh()
    if mesh is None:
        return 1
    spec = rules.cache_pspec("k", (1, 1, cfg.n_kv_heads, cfg.hd), mesh)
    return mesh.axis_size("model") if spec[-2] == "model" else 1


def _qkv(h, lp, cfg: ModelConfig, spec, positions, split: int = 1):
    """q, k, v with rope; with `split` > 1 the rank's heads only."""
    b, s, _ = h.shape
    hd = cfg.hd
    whole = split == 1
    q = AL.dense(h, lp["wq"], lp.get("bq"), spec, gather=whole).reshape(
        b, s, cfg.n_heads // split, hd)
    k = AL.dense(h, lp["wk"], lp.get("bk"), spec, gather=whole).reshape(
        b, s, cfg.n_kv_heads // split, hd)
    v = AL.dense(h, lp["wv"], lp.get("bv"), spec, gather=whole).reshape(
        b, s, cfg.n_kv_heads // split, hd)
    q = C.apply_rope(q, positions, cfg.rope_theta)
    k = C.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _ffn(h, lp, cfg: ModelConfig, spec):
    """The block's FFN -> (out, aux): an MoE layer's routed experts over
    the flattened (b * s) rows, plus its shared expert where the config
    has one, with the router's load-balance term as aux (a training loss:
    `forward` sums it over the blocks, serving drops it); else SwiGLU or
    the GELU MLP, with aux 0."""
    if "router" in lp:
        b, s, d = h.shape
        out, aux = moe_ffn(h.reshape(b * s, d), lp["router"], lp["we_gate"],
                           lp["we_up"], lp["we_down"], cfg.top_k,
                           cfg.capacity_factor, spec)
        out = out.reshape(b, s, d)
        if cfg.shared_expert:
            out = out + C.swiglu(h, lp["ws_gate"], lp["ws_up"],
                                 lp["ws_down"], spec)
        return out, aux
    if "w_gate" in lp:
        return C.swiglu(h, lp["w_gate"], lp["w_up"], lp["w_down"],
                        spec), 0.0
    return C.gelu_mlp(h, lp["w_up"], lp["mb_up"], lp["w_down"],
                      lp["mb_down"], spec), 0.0


def _self_attention(h, lp, cfg: ModelConfig, spec, positions):
    """The pre-norm causal self-attention and its residual -> (h, k, v)."""
    b, s, _ = h.shape
    x = C.rmsnorm(h, lp["ln1"])
    split = head_split(cfg)
    q, k, v = _qkv(x, lp, cfg, spec, positions, split)
    attn = _whole_heads(functools.partial(
        C.attention, impl=cfg.attn_impl, chunk=cfg.attn_chunk,
        policy=spec.policy if spec is not None else None), split, q, k, v)
    attn = AL.gather_cols(attn.reshape(b, s, -1), split)
    return h + AL.dense(attn, lp["wo"], None, spec), k, v


def decoder_block(h, lp, cfg: ModelConfig, spec, positions):
    """The standard pre-norm block over a full sequence -> (h, aux)."""
    h, _, _ = _self_attention(h, lp, cfg, spec, positions)
    ff, aux = _ffn(C.rmsnorm(h, lp["ln2"]), lp, cfg, spec)
    return h + ff, aux


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


def _unstacked(params: Params, cfg: ModelConfig) -> Params:
    """`params` with every layer stack split into per-block views
    (`C.unstack`), for `forward`'s backward."""
    out = dict(params)
    out["layers"] = C.unstack(params["layers"],
                              2 if _interleaved(cfg) else len(_lead(cfg)))
    for name in ("moe", "cross"):
        if name in params:
            out[name] = C.unstack(params[name], 1)
    return out


def _blocks(params: Params, cfg: ModelConfig):
    """Every self-attention block in order, as (its cache index, its
    params, the superblock's cross params after it or None): an
    interleaved MoE superblock's dense layers, then its MoE layer."""
    if _interleaved(cfg):
        n_super, m = _lead(cfg)
        for i in range(n_super):
            for j in range(m - 1):
                yield (i, j), C.block_params(params["layers"], i, j), None
            yield (i, m - 1), C.block_params(params["moe"], i), None
        return
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
# forward (training)
# --------------------------------------------------------------------------

def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
            spec=None, img_embeds: torch.Tensor | None = None) -> tuple:
    """tokens (b, s) -> (logits (b, s, v), aux): aux sums the MoE layers'
    load-balance terms, once per block (0.0 for a dense model).  Under
    `cfg.remat` each block, and each cross-attention layer, reruns whole
    in the backward.  A cross-attention model attends to `img_embeds`
    (b, n_img, d), zeros when None."""
    b, s = tokens.shape
    h = AL.embed(tokens, params["embed"])
    positions = torch.arange(s, device=tokens.device)[None, :]
    img = _image(img_embeds, cfg, b, h) if cfg.cross_every else None
    block = C.maybe_remat(
        lambda hh, lp: decoder_block(hh, lp, cfg, spec, positions), cfg.remat)
    cross = C.maybe_remat(
        lambda hh, xp: cross_block(hh, xp, img, cfg, spec), cfg.remat)
    aux = 0.0
    for _, lp, xp in _blocks(_unstacked(params, cfg), cfg):
        h, ai = block(h, lp)
        aux = aux + ai
        if xp is not None:
            h = cross(h, xp)
    h = C.rmsnorm(h, params["final_norm"])
    return AL.gemm(h, _head(params, cfg), spec), aux


# --------------------------------------------------------------------------
# serving: prefill + decode with KV cache
# --------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: torch.device, dtype=None) -> dict:
    """K/V of every layer; under the active mesh the rank's block by
    `cache_pspec`'s model-axis rule (its heads, where `head_split`)."""
    dtype = dtype or getattr(torch, cfg.dtype)
    shape = (*_lead(cfg), batch, max_len, cfg.n_kv_heads, cfg.hd)
    mesh = ctx.active_mesh()
    if mesh is not None:
        shape = rules.local_shape(shape, rules.cache_pspec("k", shape, mesh),
                                  mesh, axes=("model",))
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "length": torch.zeros((), dtype=torch.int32, device=device),
    }


def _whole_heads(attend, split: int, q, *kv):
    """`attend(q, *kv)` on the rank's heads (`split` > 1: q holds
    n_heads / split of them, each of `kv` n_kv_heads / split), bit for
    bit as one device computes them, forward and backward.  The rank's
    heads are placed at their own offsets among zero heads of the whole
    count and attend there: the batched products then have one device's
    shapes (cuBLAS picks its kernel by the batch count, rows x kv heads,
    and another kernel rounds differently: the decode attention's
    products and the blockwise attention's backward did), and the zero
    heads' outputs are dropped (their gradients are zero).  The rank
    pays one device's attention and a padded copy of its q, K and V."""
    if split == 1:
        return attend(q, *kv)
    r = ctx.active_mesh().axis_index("model")

    def whole(x):
        n = x.shape[2]
        out = x.new_zeros(*x.shape[:2], n * split, *x.shape[3:])
        out[:, :, r * n:(r + 1) * n] = x
        return out

    h = q.shape[2]
    o = attend(whole(q), *(whole(x) for x in kv))
    return o[:, :, r * h:(r + 1) * h]


def _decode_block(h, lp, ck, cv, lengths, cfg: ModelConfig, spec):
    """Single-token block against cache slices ck/cv (b, smax, kv, hd),
    which it updates in place; `lengths` is per-row (b,)."""
    b = h.shape[0]
    x = C.rmsnorm(h, lp["ln1"])
    split = head_split(cfg)
    q, k, v = _qkv(x, lp, cfg, spec, lengths[:, None], split)
    C.rowwise_cache_update(ck, k, lengths)
    C.rowwise_cache_update(cv, v, lengths)
    attn = _whole_heads(
        lambda q, ck, cv: C.decode_attention(q, ck, cv, lengths + 1),
        split, q, ck, cv)
    attn = AL.gather_cols(attn.reshape(b, 1, -1), split)
    h = h + AL.dense(attn, lp["wo"], None, spec)
    x = C.rmsnorm(h, lp["ln2"])
    return h + _ffn(x, lp, cfg, spec)[0]


def decode_step(params: Params, cache: dict, tokens: torch.Tensor,
                cfg: ModelConfig, spec=None,
                img_embeds: torch.Tensor | None = None) -> tuple:
    """tokens (b, 1) -> (logits (b, 1, v), cache).

    cache["length"] may be a scalar (lock-step batch) or per-row (b,)
    (continuous batching).  The K/V buffers are updated in place; the
    returned dict shares them and carries length + 1.  A cross-attention
    model attends to `img_embeds` (b, n_img, d), zeros when None."""
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
    b, s = tokens.shape
    max_len = max_len or s
    h = AL.embed(tokens, params["embed"])
    positions = torch.arange(s, device=tokens.device)[None, :]
    cache = init_cache(cfg, b, max_len, tokens.device)
    img = _image(img_embeds, cfg, b, h) if cfg.cross_every else None
    for idx, lp, xp in _blocks(params, cfg):
        h, k, v = _self_attention(h, lp, cfg, spec, positions)
        h = h + _ffn(C.rmsnorm(h, lp["ln2"]), lp, cfg, spec)[0]
        cache["k"][idx][:, :s] = k
        cache["v"][idx][:, :s] = v
        if xp is not None:
            h = cross_block(h, xp, img, cfg, spec)
    h = C.rmsnorm(C.last_valid_slice(h, true_len), params["final_norm"])
    logits = AL.gemm(h, _head(params, cfg), spec)[:, 0]
    cache["length"] = C.prefill_length(true_len, s, tokens.device)
    return logits, cache
