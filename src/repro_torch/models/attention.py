"""Blockwise (flash-style) attention with a custom backward, the
counterpart of the JAX package's `repro.models.attention`.

The forward is an online softmax over key chunks, O(chunk * s) live
memory, and returns each row's log-sum-exp beside the output.  Under
autograd only (q, k, v, out, lse) are saved, and the backward recomputes
each block's probabilities from the lse, as the reference's custom VJP
does (`_bwd_inner`): di = rowsum(dO * O), then per chunk pair
p = exp(s - lse), dv, dp, ds = p * (dp - di) * scale, dq, dk.  Saved
memory stays O(s * d), whatever the sequence length.

A sliding window keeps the reference's own windowed branch: K and V are
padded by `w` positions on the left, and each query chunk takes one
softmax over its (w + c)-position slice.  A query at position i sees the
keys at i - window ... i, as the reference's mask `(qi - ki) <= window`
has it.  Causal key chunks above the diagonal are skipped in both
directions: every score there is masked, so they add exact zeros.
Plain PyTorch ops: the reference's flash kernel has no window and no
backward, so no kernel sits on this path.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NEG = -1e30


def _pad_seq(x: torch.Tensor, c: int) -> torch.Tensor:
    pad = (-x.shape[1]) % c
    return F.pad(x, (0, 0) * (x.ndim - 2) + (0, pad)) if pad else x


def _shape5(x: torch.Tensor, kvh: int) -> torch.Tensor:
    """(b, s, h, d) -> (b, s, kv, g, d): query heads grouped by KV head."""
    b, s, h, d = x.shape
    return x.reshape(b, s, kvh, h // kvh, d)


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


def _kv_chunks(iq: int, nk: int, causal: bool) -> range:
    """Key chunks query chunk `iq` attends to: all, or up to the diagonal."""
    return range(min(nk, iq + 1) if causal else nk)


def _fwd_inner(q, k, v, chunk: int, causal: bool, window: int):
    """-> (out (b, sq, h, d) in q's dtype, lse (b, kv, g, sp) f32 over the
    chunk-padded query length)."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    c = max(1, min(chunk, sq))
    qp, kp, vp = _pad_seq(q, c), _pad_seq(k, c), _pad_seq(v, c)
    spq, nk = qp.shape[1], kp.shape[1] // c
    qg = _shape5(qp, kvh)
    g = h // kvh
    scale = d ** -0.5
    dev = q.device
    if window:
        w = min(window, skv)
        kw = F.pad(kp, (0, 0, 0, 0, w, 0)).float()
        vw = F.pad(vp, (0, 0, 0, 0, w, 0)).float()
    else:
        kc = kp.reshape(b, nk, c, kvh, d).float()
        vc = vp.reshape(b, nk, c, kvh, d).float()
    outs, lses = [], []
    for iq in range(spq // c):
        qs = qg[:, iq * c:(iq + 1) * c].float() * scale       # (b,c,kv,g,d)
        if window:
            ks = kw[:, iq * c:iq * c + w + c]                  # padded coords
            vs = vw[:, iq * c:iq * c + w + c]
            sc = torch.einsum("bqkgd,bmkd->bkgqm", qs, ks)
            m = _mask_for(iq, iq * c - w, c, w + c, sq, skv, causal, window,
                          dev)
            sc = torch.where(m, sc, torch.full_like(sc, NEG))
            mx = sc.amax(dim=-1)
            p = torch.exp(sc - mx[..., None])
            l_f = p.sum(-1)
            acc = torch.einsum("bkgqm,bmkd->bkgqd", p, vs)
            m_f = mx
        else:
            m_f = torch.full((b, kvh, g, c), NEG, device=dev)
            l_f = torch.zeros((b, kvh, g, c), device=dev)
            acc = torch.zeros((b, kvh, g, c, d), device=dev)
            qi = iq * c + torch.arange(c, device=dev)
            for ik in _kv_chunks(iq, nk, causal):
                ki = ik * c + torch.arange(c, device=dev)
                sc = torch.einsum("bqkgd,bmkd->bkgqm", qs, kc[:, ik])
                if causal:
                    mask = qi[:, None] >= ki[None, :]
                else:
                    mask = (ki[None, :] < skv).expand(c, c)
                sc = torch.where(mask, sc, torch.full_like(sc, NEG))
                m_n = torch.maximum(m_f, sc.amax(dim=-1))
                p = torch.exp(sc - m_n[..., None])
                alpha = torch.exp(m_f - m_n)
                l_f = alpha * l_f + p.sum(-1)
                acc = acc * alpha[..., None] + torch.einsum(
                    "bkgqm,bmkd->bkgqd", p, vc[:, ik])
                m_f = m_n
        l_c = torch.clamp(l_f, min=1e-30)
        outs.append((acc / l_c[..., None]).permute(0, 3, 1, 2, 4))
        lses.append(m_f + torch.log(l_c))
    out = torch.cat(outs, dim=1).reshape(b, spq, h, d)
    return out[:, :sq].to(q.dtype), torch.cat(lses, dim=-1)


def _bwd_inner(q, k, v, out, lse, grad, chunk: int, causal: bool,
               window: int):
    """The reference's `_bwd_inner` -> (dq, dk, dv) in the inputs' dtypes."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    c = max(1, min(chunk, sq))
    qp, kp, vp = _pad_seq(q, c), _pad_seq(k, c), _pad_seq(v, c)
    spq, spk = qp.shape[1], kp.shape[1]
    nk = spk // c
    scale = d ** -0.5
    dev = q.device
    qg = _shape5(qp, kvh).float()
    gg = _shape5(_pad_seq(grad.float(), c), kvh)
    og = _shape5(_pad_seq(out.float(), c), kvh)
    w = min(window, skv) if window else 0
    kf = F.pad(kp, (0, 0, 0, 0, w, 0)).float()
    vf = F.pad(vp, (0, 0, 0, 0, w, 0)).float()
    dk = torch.zeros((b, spk + w, kvh, d), device=dev)
    dv = torch.zeros((b, spk + w, kvh, d), device=dev)
    dqs = []
    for iq in range(spq // c):
        rows = slice(iq * c, (iq + 1) * c)
        qs = qg[:, rows] * scale
        gs, os_ = gg[:, rows], og[:, rows]
        lse_i = lse[..., rows]
        di = torch.einsum("bqkgd,bqkgd->bkgq", gs, os_)     # rowsum(dO * O)

        def block_grads(start: int, width: int, jk: int):
            """Gradients of the key slice [start, start + width) of the
            padded K / V, whose first key sits at global position jk."""
            ks, vs = kf[:, start:start + width], vf[:, start:start + width]
            sc = torch.einsum("bqkgd,bmkd->bkgqm", qs, ks)
            m = _mask_for(iq, jk, c, width, sq, skv, causal, window, dev)
            sc = torch.where(m, sc, torch.full_like(sc, NEG))
            p = torch.exp(sc - lse_i[..., None])               # (b,kv,g,q,m)
            dv[:, start:start + width] += torch.einsum(
                "bkgqm,bqkgd->bmkd", p, gs)
            dp = torch.einsum("bqkgd,bmkd->bkgqm", gs, vs)
            ds = p * (dp - di[..., None]) * scale
            dk[:, start:start + width] += torch.einsum(
                "bkgqm,bqkgd->bmkd", ds, qs) / scale
            return torch.einsum("bkgqm,bmkd->bqkgd", ds, ks)

        if window:
            dqs.append(block_grads(iq * c, w + c, iq * c - w))
        else:
            dq_i = torch.zeros_like(qs)
            for jk in _kv_chunks(iq, nk, causal):
                dq_i = dq_i + block_grads(jk * c, c, jk * c)
            dqs.append(dq_i)
    dq = torch.cat(dqs, dim=1).reshape(b, spq, h, d)[:, :sq]
    return (dq.to(q.dtype), dk[:, w:w + skv].to(k.dtype),
            dv[:, w:w + skv].to(v.dtype))


class _BlockwiseAttention(torch.autograd.Function):
    """The reference's `custom_vjp`: saves (q, k, v, out, lse) only."""

    @staticmethod
    def forward(ctx, q, k, v, chunk, causal, window):
        out, lse = _fwd_inner(q, k, v, chunk, causal, window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (chunk, causal, window)
        return out

    @staticmethod
    def backward(ctx, grad):
        q, k, v, out, lse = ctx.saved_tensors
        return (*_bwd_inner(q, k, v, out, lse, grad, *ctx.args),
                None, None, None)


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        chunk: int = 512, causal: bool = True,
                        window: int = 0) -> torch.Tensor:
    """q (b, sq, h, d); k, v (b, skv, kvh, d) -> (b, sq, h, d).  A
    non-causal call may attend across lengths (cross-attention)."""
    return _BlockwiseAttention.apply(q, k, v, chunk, causal, window)
