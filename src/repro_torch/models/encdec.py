"""Whisper-style encoder-decoder backbone (arXiv:2212.04356), the serving
path: init, the encoder, prefill with right-padded prompts and
per-row-length decode against self- and cross-attention caches.

As in the JAX package's `repro.models.encdec`, the audio frontend (log-mel
and conv downsampling) is a stub: requests carry precomputed frame
embeddings (b, enc_seq, d), which the encoder consumes directly.  Kept:
LayerNorm with a bias, biased attention projections (q, v, out; no k
bias), the GELU MLP with biases, sinusoidal encoder positions, learned
decoder positions and the head tied to the token embedding.  The layer
scans become Python loops over the stacked params.  `forward` is the
teacher-forced training pass.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.approx import layers as AL
from repro_torch.configs.base import ModelConfig
from repro_torch.models import common as C

Params = dict[str, Any]
MAX_DEC_POS = 32768  # learned decoder positions table

#: Serving weight-plane cache eligibility (api.prepare_params): attention
#: and MLP projections of both stacks (self- and cross-attention share
#: the "x"-prefixed names).  The tied head reuses the embedding transpose
#: and stays on the live path: it quantizes `embed.T` at every call.
PREPARED_GEMM_WEIGHTS = frozenset({
    "wq", "wk", "wv", "wo", "xwq", "xwk", "xwv", "xwo", "m_up", "m_down",
})

#: Cache leaves that `decode_step` reads and never writes: the encoder's
#: cross-attention K/V, made once at prefill.  `decode_step` returns them
#: as the same tensors, so a serving engine need not copy or snapshot them
#: around a step.
STATIC_CACHE_KEYS = frozenset({"xk", "xv"})


def _attn_shapes(cfg: ModelConfig) -> dict[str, tuple]:
    d, hd = cfg.d_model, cfg.hd
    h, kv = cfg.n_heads, cfg.n_kv_heads
    return {"wq": (d, h * hd), "bq": (h * hd,),
            "wk": (d, kv * hd),
            "wv": (d, kv * hd), "bv": (kv * hd,),
            "wo": (h * hd, d), "bo": (d,)}


def _block_shapes(cfg: ModelConfig, cross: bool) -> dict[str, tuple]:
    d, f = cfg.d_model, cfg.d_ff
    shapes = {"ln1": (d,), "ln1b": (d,)} | _attn_shapes(cfg)
    if cross:
        shapes |= {"xln": (d,), "xlnb": (d,)}
        shapes |= {"x" + k: v for k, v in _attn_shapes(cfg).items()}
    shapes |= {"ln2": (d,), "ln2b": (d,), "m_up": (d, f), "mb_up": (f,),
               "m_down": (f, d), "mb_down": (d,)}
    return shapes


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: torch.device) -> Params:
    """Random params with the reference's distributions (normal x
    fan_in^-0.5 for GEMM weights, x 0.02 for the embedding, x 0.01 for the
    decoder positions, zeros for norms and biases), drawn from
    `generator` on `device`."""
    dtype = getattr(torch, cfg.dtype)

    def normal(shape, scale):
        return (torch.randn(shape, generator=generator, device=device,
                            dtype=torch.float32) * scale).to(dtype)

    def zeros(shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def stack(shapes, n):
        out = {}
        for name, shp in sorted(shapes.items()):
            full = (n, *shp)
            out[name] = (zeros(full) if len(shp) < 2
                         else normal(full, shp[-2] ** -0.5))
        return out

    d = cfg.d_model
    return {
        "embed": normal((cfg.vocab, d), 0.02),
        "dec_pos": normal((MAX_DEC_POS, d), 0.01),
        "enc_layers": stack(_block_shapes(cfg, cross=False),
                            cfg.n_enc_layers),
        "dec_layers": stack(_block_shapes(cfg, cross=True), cfg.n_layers),
        "enc_norm": zeros((d,)), "enc_normb": zeros((d,)),
        "final_norm": zeros((d,)), "final_normb": zeros((d,)),
    }


def _project_kv(kv_src, p, cfg: ModelConfig, spec, prefix: str = ""):
    """K and V of `kv_src` (b, s_kv, d): (b, s_kv, kv, hd) each."""
    b, s_kv, _ = kv_src.shape
    k = AL.dense(kv_src, p[prefix + "wk"], None, spec)
    v = AL.dense(kv_src, p[prefix + "wv"], p[prefix + "bv"], spec)
    return (k.reshape(b, s_kv, cfg.n_kv_heads, cfg.hd),
            v.reshape(b, s_kv, cfg.n_kv_heads, cfg.hd))


def _mha(x, kv_src, p, cfg: ModelConfig, spec, prefix: str = "",
         causal: bool = True, kv: tuple | None = None):
    """Attention of `x` over `kv_src`, projections biased as Whisper's.
    `kv` passes K and V already projected from `kv_src` (prefill computes
    the cross K/V once and keeps them for the cache).  The impl rule is
    the reference's: the config's impl when the two lengths are equal,
    `naive` across lengths (`chunked` past 2^22 scores, then `naive` again
    across lengths)."""
    b, s, _ = x.shape
    q = AL.dense(x, p[prefix + "wq"], p[prefix + "bq"], spec).reshape(
        b, s, cfg.n_heads, cfg.hd)
    k, v = kv if kv is not None else _project_kv(kv_src, p, cfg, spec,
                                                 prefix)
    s_kv = kv_src.shape[1]
    impl = cfg.attn_impl if s == s_kv else "naive"
    if s * s_kv > (1 << 22) and impl == "naive":
        impl = "chunked"
    if impl == "chunked" and s != s_kv:
        impl = "naive"
    attn = C.attention(q, k, v, impl=impl, chunk=cfg.attn_chunk,
                       causal=causal,
                       policy=spec.policy if spec is not None else None)
    return AL.dense(attn.reshape(b, s, -1), p[prefix + "wo"],
                    p[prefix + "bo"], spec)


def _gelu_mlp(x, lp, spec):
    return C.gelu_mlp(x, lp["m_up"], lp["mb_up"], lp["m_down"],
                      lp["mb_down"], spec)


def _enc_block(h, lp, cfg: ModelConfig, spec):
    x = C.layernorm(h, lp["ln1"], lp["ln1b"])
    h = h + _mha(x, x, lp, cfg, spec, causal=False)
    x = C.layernorm(h, lp["ln2"], lp["ln2b"])
    return h + _gelu_mlp(x, lp, spec)


def encode(params: Params, frames: torch.Tensor, cfg: ModelConfig,
           spec=None) -> torch.Tensor:
    """frames (b, enc_seq, d) — precomputed frame embeddings (stub)."""
    h = frames + C.sinusoid_positions(frames.shape[1], cfg.d_model,
                                      frames.device).to(frames.dtype)
    layers = C.unstack(params["enc_layers"], 1)
    blk = C.maybe_remat(lambda hh, lp: _enc_block(hh, lp, cfg, spec),
                        cfg.remat)
    for i in range(cfg.n_enc_layers):
        h = blk(h, C.block_params(layers, i))
    return C.layernorm(h, params["enc_norm"], params["enc_normb"])


def _dec_block(h, enc_out, lp, cfg: ModelConfig, spec):
    """The decoder block over a full sequence (training): causal
    self-attention, cross-attention to `enc_out`, the GELU MLP."""
    x = C.layernorm(h, lp["ln1"], lp["ln1b"])
    h = h + _mha(x, x, lp, cfg, spec, causal=True)
    x = C.layernorm(h, lp["xln"], lp["xlnb"])
    h = h + _mha(x, enc_out, lp, cfg, spec, prefix="x", causal=False)
    x = C.layernorm(h, lp["ln2"], lp["ln2b"])
    return h + _gelu_mlp(x, lp, spec)


def _frames(frames, cfg: ModelConfig, b: int, device) -> torch.Tensor:
    """The request's frames, zeros when it carries none (the reference's
    default)."""
    if frames is not None:
        return frames
    return torch.zeros((b, cfg.enc_seq, cfg.d_model),
                       dtype=getattr(torch, cfg.dtype), device=device)


def _head(h, params: Params, spec):
    return AL.gemm(h, params["embed"].T, spec)


def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
            spec=None, frames: torch.Tensor | None = None, **_) -> tuple:
    """The teacher-forced decoder over (b, s) tokens given encoder
    `frames` (zeros when None) -> (logits (b, s, v), 0.0); under
    `cfg.remat` every encoder and decoder block reruns in the backward."""
    b, s = tokens.shape
    enc_out = encode(params, _frames(frames, cfg, b, tokens.device), cfg,
                     spec)
    h = AL.embed(tokens, params["embed"]) + params["dec_pos"][:s][None]
    layers = C.unstack(params["dec_layers"], 1)
    blk = C.maybe_remat(
        lambda hh, lp, eo: _dec_block(hh, eo, lp, cfg, spec), cfg.remat)
    for i in range(cfg.n_layers):
        h = blk(h, C.block_params(layers, i), enc_out)
    h = C.layernorm(h, params["final_norm"], params["final_normb"])
    return _head(h, params, spec), 0.0


# --- serving -------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: torch.device, dtype=None) -> dict:
    dtype = dtype or getattr(torch, cfg.dtype)
    kv, hd, L = cfg.n_kv_heads, cfg.hd, cfg.n_layers

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return {
        "k": zeros(L, batch, max_len, kv, hd),
        "v": zeros(L, batch, max_len, kv, hd),
        # cross-attention K/V computed once from the encoder output
        "xk": zeros(L, batch, cfg.enc_seq, kv, hd),
        "xv": zeros(L, batch, cfg.enc_seq, kv, hd),
        "length": torch.zeros((), dtype=torch.int32, device=device),
    }


def precompute_cross(params: Params, enc_out: torch.Tensor,
                     cfg: ModelConfig, spec=None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-layer cross K/V from the encoder output: (L, b, enc_seq, kv, hd)
    each."""
    kvs = [_project_kv(enc_out, C.block_params(params["dec_layers"], i),
                       cfg, spec, "x") for i in range(cfg.n_layers)]
    return (torch.stack([k for k, _ in kvs]),
            torch.stack([v for _, v in kvs]))


def prefill(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
            spec=None, max_len: int | None = None,
            frames: torch.Tensor | None = None,
            true_len: torch.Tensor | None = None) -> tuple:
    """Encode `frames` (zeros when None), then the teacher-forced decoder
    pass collecting the self K/V and the cross K/V.  `true_len` (b,)
    supports right-padded prompts (causal self-attention keeps the valid
    rows exact; pads are masked at decode through per-row lengths).  The
    cross K/V are projected once per layer and serve both the layer's
    cross-attention and the cache: the reference projects them a second
    time in `precompute_cross`, the same GEMMs on the same inputs."""
    b, s = tokens.shape
    max_len = max_len or s
    policy = spec.policy if spec is not None else None
    enc_out = encode(params, _frames(frames, cfg, b, tokens.device), cfg,
                     spec)
    h = AL.embed(tokens, params["embed"]) + params["dec_pos"][:s][None]
    cache = init_cache(cfg, b, max_len, tokens.device)
    for i in range(cfg.n_layers):
        lp = C.block_params(params["dec_layers"], i)
        x = C.layernorm(h, lp["ln1"], lp["ln1b"])
        q = AL.dense(x, lp["wq"], lp["bq"], spec).reshape(
            b, s, cfg.n_heads, cfg.hd)
        k, v = _project_kv(x, lp, cfg, spec)
        attn = C.attention(q, k, v, impl=cfg.attn_impl, chunk=cfg.attn_chunk,
                           policy=policy)
        h = h + AL.dense(attn.reshape(b, s, -1), lp["wo"], lp["bo"], spec)
        x = C.layernorm(h, lp["xln"], lp["xlnb"])
        xk, xv = _project_kv(enc_out, lp, cfg, spec, "x")
        h = h + _mha(x, enc_out, lp, cfg, spec, prefix="x", causal=False,
                     kv=(xk, xv))
        x = C.layernorm(h, lp["ln2"], lp["ln2b"])
        h = h + _gelu_mlp(x, lp, spec)
        cache["k"][i, :, :s] = k
        cache["v"][i, :, :s] = v
        cache["xk"][i] = xk
        cache["xv"][i] = xv
    h = C.layernorm(C.last_valid_slice(h, true_len), params["final_norm"],
                    params["final_normb"])
    logits = _head(h, params, spec)[:, 0]
    cache["length"] = C.prefill_length(true_len, s, tokens.device)
    return logits, cache


def decode_step(params: Params, cache: dict, tokens: torch.Tensor,
                cfg: ModelConfig, spec=None,
                frames: torch.Tensor | None = None) -> tuple:
    """tokens (b, 1) -> (logits (b, 1, v), cache).  Each row takes the
    learned decoder position at its own length; the self K/V are written
    in place as in the dense family, the cross-attention reads `xk`/`xv`
    at their full length, and the returned dict shares every buffer and
    carries length + 1.  `frames` is accepted and unused, as in the
    reference: prefill consumed them into `xk`/`xv`."""
    b = tokens.shape[0]
    length = C.cache_lengths(cache, b)
    h = AL.embed(tokens, params["embed"]) + \
        params["dec_pos"][length.long()][:, None]
    full = torch.full((b,), cache["xk"].shape[2], dtype=torch.int32,
                      device=tokens.device)
    for i in range(cfg.n_layers):
        lp = C.block_params(params["dec_layers"], i)
        ck, cv = cache["k"][i], cache["v"][i]
        x = C.layernorm(h, lp["ln1"], lp["ln1b"])
        q = AL.dense(x, lp["wq"], lp["bq"], spec).reshape(
            b, 1, cfg.n_heads, cfg.hd)
        k, v = _project_kv(x, lp, cfg, spec)
        C.rowwise_cache_update(ck, k, length)
        C.rowwise_cache_update(cv, v, length)
        attn = C.decode_attention(q, ck, cv, length + 1)
        h = h + AL.dense(attn.reshape(b, 1, -1), lp["wo"], lp["bo"], spec)
        x = C.layernorm(h, lp["xln"], lp["xlnb"])
        qx = AL.dense(x, lp["xwq"], lp["xbq"], spec).reshape(
            b, 1, cfg.n_heads, cfg.hd)
        xattn = C.decode_attention(qx, cache["xk"][i], cache["xv"][i], full)
        h = h + AL.dense(xattn.reshape(b, 1, -1), lp["xwo"], lp["xbo"],
                         spec)
        x = C.layernorm(h, lp["ln2"], lp["ln2b"])
        h = h + _gelu_mlp(x, lp, spec)
    h = C.layernorm(h, params["final_norm"], params["final_normb"])
    logits = _head(h, params, spec)
    return logits, dict(cache, length=cache["length"] + 1)
