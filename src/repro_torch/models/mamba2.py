"""Mamba-2 (SSD, state-space duality): the chunked-parallel prefill form and
the O(1)-state decode, the counterpart of the JAX package's
`repro.models.mamba2` (arXiv:2405.21060).

The in/out projections and the head route through the approximate GEMM
(`spec`); the SSD recurrence, the depthwise conv and the gates are f32
elementwise and state math, XLA code in the reference and plain PyTorch
ops here: no kernel of the reference sits on them.  The inter-chunk
`lax.scan` becomes a loop over chunks, the layer scans loops over layers.
The SSD's four-operand einsum contracts pairwise in another order than
XLA's, which moves results by ulps.

`decode_step` never writes a state in place: it returns fresh `conv` and
`ssm` tensors, which the paged engine's draft and verify snapshots rely on.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.approx import layers as AL
from repro_torch.configs.base import ModelConfig
from repro_torch.models import common as C

Params = dict[str, Any]
NGROUPS = 1

#: Param leaves of the serving weight-plane cache (api.prepare_params):
#: the in/out projections and the head.  Conv taps, the SSD parameters
#: (A_log / D / dt_bias) and norms are read directly and stay raw.
PREPARED_GEMM_WEIGHTS = frozenset({"in_proj", "out_proj", "lm_head"})


def _dims(cfg: ModelConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    nheads = cfg.ssm_heads or (d_in // cfg.ssm_head_dim)
    p = d_in // nheads
    n = cfg.ssm_state
    conv_ch = d_in + 2 * NGROUPS * n
    return d_in, nheads, p, n, conv_ch


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: torch.device) -> Params:
    """Random params with the reference's distributions, drawn from
    `generator` on `device`.  A_log, D and dt_bias are f32 whatever
    `cfg.dtype` is, as in the reference."""
    dtype = getattr(torch, cfg.dtype)
    d = cfg.d_model
    d_in, h, p, n, conv_ch = _dims(cfg)
    L = cfg.n_layers
    f32 = dict(dtype=torch.float32, device=device)

    def normal(shape, scale):
        return (torch.randn(shape, generator=generator, **f32)
                * scale).to(dtype)

    proj_out = 2 * d_in + 2 * NGROUPS * n + h
    a = torch.linspace(1.0, 16.0, h, **f32)
    layers = {
        "ln": torch.zeros((L, d), dtype=dtype, device=device),
        "in_proj": normal((L, d, proj_out), d ** -0.5),
        "conv_w": normal((L, cfg.conv_width, conv_ch), 0.1),
        "conv_b": torch.zeros((L, conv_ch), dtype=dtype, device=device),
        "A_log": torch.log(a).expand(L, h).contiguous(),
        "D": torch.ones((L, h), **f32),
        "dt_bias": torch.zeros((L, h), **f32),
        "norm_gate": torch.zeros((L, d_in), dtype=dtype, device=device),
        "out_proj": normal((L, d_in, d), d_in ** -0.5),
    }
    return {
        "embed": normal((cfg.vocab, d), 0.02),
        "layers": layers,
        "final_norm": torch.zeros((d,), dtype=dtype, device=device),
        "lm_head": normal((d, cfg.vocab), 0.02),
    }


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x (..., l) -> (..., l, l) with out[i, j] = sum x[j+1..i], -inf above
    the diagonal."""
    l = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    d = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((l, l), dtype=torch.bool, device=x.device).tril()
    return torch.where(mask, d, torch.full_like(d, -torch.inf))


def ssd_scan(x: torch.Tensor, dtA: torch.Tensor, B: torch.Tensor,
             Cm: torch.Tensor, chunk: int,
             init_state: torch.Tensor | None = None):
    """Chunked SSD.  x (b, s, h, p); dtA (b, s, h) (= dt * A, negative);
    B, Cm (b, s, g, n).  Returns (y (b, s, h, p), final state (b, h, p,
    n)).  `s` must be a multiple of the chunk (or below it)."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    q = min(chunk, s)
    assert s % q == 0, (s, q)
    c = s // q
    hg = h // g

    xg = x.reshape(b, c, q, g, hg, p)
    Ac = dtA.reshape(b, c, q, h).permute(0, 3, 1, 2)          # (b,h,c,q)
    Bc = B.reshape(b, c, q, g, n)
    Cc = Cm.reshape(b, c, q, g, n)
    A_cum = torch.cumsum(Ac, dim=-1)                          # (b,h,c,q)

    # intra-chunk (diagonal) term: (C B^T) * L, then against x
    Lg = torch.exp(_segsum(Ac)).reshape(b, g, hg, c, q, q)    # (..,l,s)
    cb = torch.einsum("bclgn,bcsgn->bcgls", Cc, Bc)
    w = cb[:, :, :, None] * Lg.permute(0, 3, 1, 2, 4, 5)      # (b,c,g,hg,l,s)
    y_diag = torch.einsum("bcghls,bcsghp->bclghp", w, xg)

    # chunk states
    decay = torch.exp(A_cum[..., -1:] - A_cum).reshape(b, g, hg, c, q)
    xd = xg * decay.permute(0, 3, 4, 1, 2)[..., None]         # (b,c,q,g,hg,p)
    states = torch.einsum("bclgn,bclghp->bcghpn", Bc, xd)

    # inter-chunk recurrence: a loop over chunks (the reference's scan)
    chunk_decay = torch.exp(A_cum[..., -1]).reshape(b, g, hg, c)
    prev = (init_state.reshape(b, g, hg, p, n) if init_state is not None
            else torch.zeros((b, g, hg, p, n), dtype=torch.float32,
                             device=x.device))
    prevs = []
    for i in range(c):
        prevs.append(prev)
        prev = prev * chunk_decay[..., i, None, None] + states[:, i]
    prev_states = torch.stack(prevs, dim=1)                   # (b,c,g,hg,p,n)

    # inter-chunk (off-diagonal) output
    out_decay = torch.exp(A_cum).reshape(b, g, hg, c, q)
    y_off = torch.einsum("bclgn,bcghpn->bclghp", Cc, prev_states) * \
        out_decay.permute(0, 3, 4, 1, 2)[..., None]
    y = (y_diag + y_off).reshape(b, s, h, p)
    return y, prev.reshape(b, h, p, n)


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d.  x (b, s, ch), w (width, ch)."""
    width = w.shape[0]
    xp = torch.nn.functional.pad(x, (0, 0, width - 1, 0)).float()
    wf = w.float()
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(width):
        out = out + xp[:, i:i + x.shape[1]] * wf[i]
    return (out + bias.float()).to(x.dtype)


def _split_proj(z: torch.Tensor, cfg: ModelConfig):
    d_in, h, p, n, _ = _dims(cfg)
    gn = NGROUPS * n
    return torch.split(z, [d_in, d_in, gn, gn, h], dim=-1)


def block(hstate, lp, cfg: ModelConfig, spec, init_state=None,
          true_len=None):
    """One mamba2 block over a full sequence -> (h, final SSD state, conv
    tail).  `true_len` (b,) marks right-padded rows: pad positions get
    dt = 0, an identity state update, so the final state is the state
    after the last valid token; the conv tail is cut at the valid end."""
    b, s, _ = hstate.shape
    d_in, h, p, n, _ = _dims(cfg)
    x = C.rmsnorm(hstate, lp["ln"])
    z = AL.gemm(x, lp["in_proj"], spec)
    zg, xin, Bm, Cm, dt = _split_proj(z, cfg)

    conv_in = torch.cat([xin, Bm, Cm], dim=-1)
    conv_out = C.silu(_causal_conv(conv_in, lp["conv_w"], lp["conv_b"]))
    xin, Bm, Cm = torch.split(conv_out, [d_in, NGROUPS * n, NGROUPS * n],
                              dim=-1)

    dt = C.softplus(dt.float() + lp["dt_bias"])                # (b,s,h)
    mask = C.valid_mask(true_len, b, s)
    if mask is not None:
        dt = dt * mask[:, :, None]
    A = -torch.exp(lp["A_log"])                                # (h,)
    xh = xin.reshape(b, s, h, p).float()
    Bh = Bm.reshape(b, s, NGROUPS, n).float()
    Ch = Cm.reshape(b, s, NGROUPS, n).float()
    y, final_state = ssd_scan(xh * dt[..., None], dt * A, Bh, Ch,
                              cfg.ssd_chunk, init_state)
    y = y + lp["D"][None, None, :, None] * xh
    y = y.reshape(b, s, d_in).to(hstate.dtype)
    y = C.rmsnorm(y * C.silu(zg), lp["norm_gate"])
    out = AL.gemm(y, lp["out_proj"], spec)
    conv_tail = C.tail_window(conv_in, true_len, cfg.conv_width - 1)
    return hstate + out, final_state, conv_tail


def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
            spec=None, **_) -> tuple:
    """tokens (b, s) -> (logits (b, s, v), 0.0): the chunked form over the
    whole sequence, each block rerun in the backward under `cfg.remat`."""
    h = AL.embed(tokens, params["embed"])
    layers = C.unstack(params["layers"], 1)
    blk = C.maybe_remat(lambda hh, lp: block(hh, lp, cfg, spec)[0],
                        cfg.remat)
    for i in range(cfg.n_layers):
        h = blk(h, C.block_params(layers, i))
    h = C.rmsnorm(h, params["final_norm"])
    return AL.gemm(h, params["lm_head"], spec), 0.0


# --- serving ----------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: torch.device, dtype=None) -> dict:
    """Per-layer conv tail and SSD state: O(1) in the sequence length."""
    _, h, p, n, conv_ch = _dims(cfg)
    L = cfg.n_layers
    return {
        "conv": torch.zeros((L, batch, cfg.conv_width - 1, conv_ch),
                            dtype=getattr(torch, cfg.dtype), device=device),
        "ssm": torch.zeros((L, batch, h, p, n), dtype=torch.float32,
                           device=device),
        "length": torch.zeros((), dtype=torch.int32, device=device),
    }


def _decode_block(hh, lp, conv_st, ssm_st, cfg: ModelConfig, spec):
    """Single-token block -> (h, new conv window tail, new SSD state)."""
    b = hh.shape[0]
    d_in, h, p, n, _ = _dims(cfg)
    x = C.rmsnorm(hh, lp["ln"])
    z = AL.gemm(x, lp["in_proj"], spec)
    zg, xin, Bm, Cm, dt = _split_proj(z, cfg)
    conv_in = torch.cat([xin, Bm, Cm], dim=-1)                 # (b, 1, ch)
    window = torch.cat([conv_st, conv_in], dim=1)              # (b, w, ch)
    conv = (window.float() * lp["conv_w"].float()[None]).sum(1) \
        + lp["conv_b"].float()
    conv_out = C.silu(conv)[:, None, :].to(hh.dtype)
    xin, Bm, Cm = torch.split(conv_out, [d_in, NGROUPS * n, NGROUPS * n],
                              dim=-1)
    dt = C.softplus(dt[:, 0].float() + lp["dt_bias"])          # (b, h)
    da = torch.exp(dt * -torch.exp(lp["A_log"]))
    xh = xin.reshape(b, h, p).float()
    Bh = Bm.reshape(b, NGROUPS, n).float().repeat_interleave(
        h // NGROUPS, dim=1)
    Ch = Cm.reshape(b, NGROUPS, n).float().repeat_interleave(
        h // NGROUPS, dim=1)
    new_state = ssm_st * da[..., None, None] + \
        (dt[..., None] * xh)[..., None] * Bh[:, :, None, :]
    y = torch.einsum("bhpn,bhn->bhp", new_state, Ch) + lp["D"][:, None] * xh
    y = y.reshape(b, 1, d_in).to(hh.dtype)
    y = C.rmsnorm(y * C.silu(zg), lp["norm_gate"])
    return hh + AL.gemm(y, lp["out_proj"], spec), window[:, 1:], new_state


def decode_step(params: Params, cache: dict, tokens: torch.Tensor,
                cfg: ModelConfig, spec=None) -> tuple:
    """tokens (b, 1) -> (logits (b, 1, v), cache with fresh conv / ssm
    tensors and length + 1); the cache passed in is left as it was."""
    hcur = AL.embed(tokens, params["embed"])                   # (b, 1, d)
    convs, ssms = [], []
    for i in range(cfg.n_layers):
        hcur, conv, ssm = _decode_block(
            hcur, C.block_params(params["layers"], i), cache["conv"][i],
            cache["ssm"][i], cfg, spec)
        convs.append(conv)
        ssms.append(ssm)
    hcur = C.rmsnorm(hcur, params["final_norm"])
    logits = AL.gemm(hcur, params["lm_head"], spec)
    return logits, {"conv": torch.stack(convs), "ssm": torch.stack(ssms),
                    "length": cache["length"] + 1}


def prefill(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
            spec=None, max_len: int | None = None,
            true_len: torch.Tensor | None = None) -> tuple:
    """The chunked form over the prompt, its states carried into a cache.
    With `true_len` (b,), right-padded rows carry exact per-row states
    (pads are identity updates of the SSD recurrence, see `block`)."""
    b, s = tokens.shape
    hcur = AL.embed(tokens, params["embed"])
    ssms, convs = [], []
    for i in range(cfg.n_layers):
        hcur, state, tail = block(hcur, C.block_params(params["layers"], i), cfg,
                                  spec, true_len=true_len)
        ssms.append(state)
        convs.append(tail)
    hcur = C.rmsnorm(C.last_valid_slice(hcur, true_len),
                     params["final_norm"])
    logits = AL.gemm(hcur, params["lm_head"], spec)[:, 0]
    cache = {"conv": torch.stack(convs).to(getattr(torch, cfg.dtype)),
             "ssm": torch.stack(ssms),
             "length": C.prefill_length(true_len, s, tokens.device)}
    return logits, cache
