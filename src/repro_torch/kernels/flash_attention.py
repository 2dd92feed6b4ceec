"""Online-softmax (flash) attention: the wrapper of the CUDA kernel in
csrc/flash_attention.cu and its plain PyTorch version.

q (bh, sq, d), k/v (bh, skv, d) in f32 or bf16 -> (bh, sq, d) in q's
dtype, computed in f32, causal by global index.  The plain version walks
the same blocked online softmax as the JAX package's Pallas kernel (query
blocks of `bq`, kv blocks of `bkv`, kv blocks above the diagonal skipped).
The CUDA kernel fixes its own tiles (one warp per block, 8 query rows in
f32 and 16 in bf16, 32 kv rows per step).  In f32 it runs register-tiled
FP32 FMAs and agrees with the plain version within f32 rounding (2e-6);
in bf16 it runs tensor-core products with f32 accumulation (2e-2).
Neither has a backward: the wrapper refuses inputs that need a gradient.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build

DEFAULT_BQ = 512
DEFAULT_BKV = 512
NEG_INF = -1e30


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, bq: int = DEFAULT_BQ,
                          bkv: int = DEFAULT_BKV) -> torch.Tensor:
    bh, sq, d = q.shape
    skv = k.shape[1]
    bq, bkv = min(bq, sq), min(bkv, skv)
    scale = 1.0 / (d ** 0.5)
    qf, kf, vf = q.float(), k.float(), v.float()
    out = torch.empty((bh, sq, d), dtype=q.dtype, device=q.device)
    for q0 in range(0, sq, bq):
        qb = qf[:, q0:q0 + bq]
        nq = qb.shape[1]
        m = torch.full((bh, nq, 1), NEG_INF, device=q.device)
        l = torch.zeros((bh, nq, 1), device=q.device)
        acc = torch.zeros((bh, nq, d), device=q.device)
        for k0 in range(0, skv, bkv):
            if causal and k0 > q0 + nq - 1:
                break
            kb, vb = kf[:, k0:k0 + bkv], vf[:, k0:k0 + bkv]
            s = torch.matmul(qb, kb.transpose(1, 2)) * scale
            if causal:
                qi = torch.arange(q0, q0 + nq, device=q.device)[:, None]
                ki = torch.arange(k0, k0 + kb.shape[1],
                                  device=q.device)[None, :]
                s = torch.where(qi >= ki, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=2, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(dim=2, keepdim=True)
            acc = acc * alpha + torch.matmul(p, vb)
            m = m_new
        out[:, q0:q0 + nq] = (acc / torch.clamp(l, min=1e-30)).to(q.dtype)
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, bq: int | None = None,
                    bkv: int | None = None) -> torch.Tensor:
    """q (bh, sq, d), k/v (bh, skv, d) -> (bh, sq, d).  On CUDA: f32 or
    bf16, d in {32, 64, 128, 256}; `bq`/`bkv` shape only the plain
    version's blocks.  The kernel has no backward, as the reference's has
    none: inputs that need a gradient raise, on every device, rather than
    get a result that carries none."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError(
            "flash_attention has no backward: train with "
            "attn_impl='chunked' (the blockwise attention's custom "
            "backward), or call it under torch.no_grad()")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal,
                                     bq=bq or DEFAULT_BQ,
                                     bkv=bkv or DEFAULT_BKV)
    bh, sq, d = q.shape
    skv = k.shape[1]
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, "
                         f"{v.dtype}; f32 or bf16, all alike")
    if k.shape != (bh, skv, d) or v.shape != k.shape or \
            d not in (32, 64, 128, 256):
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    # 16-byte aligned rows: the kernel copies K and V in 16-byte pieces
    q, k, v = (x if x.data_ptr() % 16 == 0 else x.clone()
               for x in (q.contiguous(), k.contiguous(), v.contiguous()))
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: operands on different devices")
    o = torch.empty_like(q)
    lib = build.load()
    err = lib.repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), bh, sq, skv,
        d, int(causal), int(q.dtype == torch.bfloat16), 1.0 / (d ** 0.5),
        build.stream_ptr(q.device))
    build.check(err, "flash_attention")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
