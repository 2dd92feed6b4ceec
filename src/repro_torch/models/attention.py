"""Blockwise attention forward, the counterpart of the JAX package's
`repro.models.attention.blockwise_attention`.

Unwindowed calls are `common.chunked_attention`, the online-softmax
forward.  A sliding window keeps the reference's own windowed branch: K
and V are padded by `w` positions on the left, and each query chunk takes
one softmax over its (w + c)-position slice, so the rounding stays close
to the reference's (an online softmax would sum in another order).  A
query at position i sees the keys at i - window ... i, as the reference's
mask `(qi - ki) <= window` has it.  Plain PyTorch ops: the reference's
flash kernel has no window, so no kernel sits on this path.  The custom
backward comes with training.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import common as C

NEG = -1e30


def _pad_seq(x: torch.Tensor, c: int) -> torch.Tensor:
    pad = (-x.shape[1]) % c
    return F.pad(x, (0, 0) * (x.ndim - 2) + (0, pad)) if pad else x


def _mask_for(iq: int, jk: int, c_q: int, c_k: int, s_q: int, s_k: int,
              causal: bool, window: int, device) -> torch.Tensor:
    """(c_q, c_k) mask of query chunk `iq` against the key slice that
    starts at global position `jk`."""
    qi = iq * c_q + torch.arange(c_q, device=device)
    ki = jk + torch.arange(c_k, device=device)
    m = (ki[None, :] < s_k) & (qi[:, None] < s_q)
    if causal:
        m &= qi[:, None] >= ki[None, :]
    if window:
        m &= (qi[:, None] - ki[None, :]) <= window
        m &= ki[None, :] >= 0
    return m


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        chunk: int = 512, causal: bool = True,
                        window: int = 0) -> torch.Tensor:
    """q (b, s, h, d); k, v (b, s, kvh, d) -> (b, s, h, d)."""
    if not window:
        return C.chunked_attention(q, k, v, chunk, causal)
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    c = max(1, min(chunk, sq))
    qp, kp, vp = _pad_seq(q, c), _pad_seq(k, c), _pad_seq(v, c)
    spq = qp.shape[1]
    qg = qp.reshape(b, spq, kvh, h // kvh, d)
    scale = d ** -0.5
    w = min(window, skv)
    kp2 = F.pad(kp, (0, 0, 0, 0, w, 0)).float()
    vp2 = F.pad(vp, (0, 0, 0, 0, w, 0)).float()
    blocks = []
    for iq in range(spq // c):
        qs = qg[:, iq * c:(iq + 1) * c].float() * scale       # (b,c,kv,g,d)
        ks = kp2[:, iq * c:iq * c + w + c]                     # padded coords
        vs = vp2[:, iq * c:iq * c + w + c]
        sc = torch.einsum("bqkgd,bmkd->bkgqm", qs, ks)
        m = _mask_for(iq, iq * c - w, c, w + c, sq, skv, causal, window,
                      q.device)
        sc = torch.where(m, sc, torch.full_like(sc, NEG))
        p = torch.exp(sc - sc.amax(dim=-1, keepdim=True))
        o = torch.einsum("bkgqm,bmkd->bkgqd", p, vs)
        o = o / torch.clamp(p.sum(-1), min=1e-30)[..., None]
        blocks.append(o.permute(0, 3, 1, 2, 4))               # (b,c,kv,g,d)
    out = torch.cat(blocks, dim=1).reshape(b, spq, h, d)
    return out[:, :sq].to(q.dtype)
