"""Per-slot token sampling over the whole decode batch.

Every slot carries its own (temperature, top_k, torch.Generator); a
temperature <= 0 selects greedy (argmax, first maximum on ties, as
jnp.argmax).  Greedy rows match the JAX package exactly; sampled rows
cannot, since its generator is threefry and this one Philox.
"""

from __future__ import annotations

import torch


def sample_tokens(logits: torch.Tensor, temps: list[float],
                  top_ks: list[int],
                  generators: list[torch.Generator | None]) -> torch.Tensor:
    """logits (n, v) -> sampled ids (n,) int64."""
    lg = logits.float()
    out = torch.argmax(lg, dim=-1)
    v = lg.shape[-1]
    for i, (t, k, gen) in enumerate(zip(temps, top_ks, generators)):
        if t <= 0.0:
            continue
        row = lg[i]
        k = min(max(int(k), 0), v)
        if k > 0:
            thr = torch.topk(row, k).values[-1]
            row = torch.where(row >= thr, row,
                              torch.full_like(row, float("-inf")))
        probs = torch.softmax(row / max(t, 1e-6), dim=-1)
        out[i] = torch.multinomial(probs, 1, generator=gen)[0]
    return out
