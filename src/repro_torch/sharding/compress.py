"""Gradient compression: int8 ring reduce-scatter / all-gather with error
feedback, the counterpart of the JAX package's `repro.sharding.compress`
(there `shard_map` + `lax.ppermute`; here `Mesh.ppermute` between the
ranks of one axis).

Wire cost per rank of an N-way all-reduce of B bytes: a ring psum moves
2 (N - 1) / N x B; this path moves int8 codes and one f32 scale per hop,
(N - 1) / N x B / 2 in f32 terms, with each hop's requantization noise
on top and error feedback re-injecting the local quantization error the
next step.  As in the JAX package, a library function: the train step's
all-reduce is the exact `Mesh.all_reduce`.

The arithmetic follows the compiled reference (`jax.jit` of its
`shard_map`; its own tests run it eagerly, op by op): XLA folds the
division of the absmax by 127 into a multiply by f32(1 / 127), keeps
x / scale a true division, and contracts each dequantize-and-add into
one fused multiply-add (`torch.addcmul`, one rounding on the CPU and
the card alike): a hop's partial sum, and the error feedback's residual.
"""

from __future__ import annotations

import torch

INT8_MAX = 127.0
#: f32(1 / 127): the compiled reference's form of `absmax / 127`
_INV_127 = 0.007874015718698502


def _q(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8 codes and their f32 scale."""
    absmax = x.abs().max()
    scale = torch.clamp(absmax, min=1e-12) * _INV_127
    q = torch.clamp(torch.round(x / scale), -INT8_MAX - 1, INT8_MAX)
    return q.to(torch.int8), scale


def _dq(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * s


def _ring(n: int) -> list[tuple[int, int]]:
    return [(j, (j + 1) % n) for j in range(n)]


def ring_reduce_scatter_q(x: torch.Tensor, mesh, axis: str
                          ) -> torch.Tensor:
    """x (n * chunk,) f32 on each rank -> this rank's summed chunk, int8
    on the wire: rank i ends with sum_j x_j[(i + 1) % n] (chunk indexed
    (i + 1) mod n, the layout `ring_all_gather_q` takes)."""
    n = mesh.axis_size(axis)
    i = mesh.axis_index(axis)
    parts = x.reshape(n, -1)
    cur = parts[i]                    # partial for chunk i (local only)
    for t in range(n - 1):
        q, s = _q(cur)
        q = mesh.ppermute(q, axis, _ring(n))
        s = mesh.ppermute(s, axis, _ring(n))
        # partial for chunk (i - t - 1) mod n: dequantize + add, fused
        cur = torch.addcmul(parts[(i - t - 1) % n], q.to(torch.float32), s)
    return cur


def ring_all_gather_q(chunk: torch.Tensor, mesh, axis: str
                      ) -> torch.Tensor:
    """Inverse layout of `ring_reduce_scatter_q`: rank i contributes chunk
    (i + 1) % n; returns the whole (n * chunk,) tensor, int8 on the
    wire."""
    n = mesh.axis_size(axis)
    i = mesh.axis_index(axis)
    q, s = _q(chunk)
    out = torch.zeros((n, *chunk.shape), dtype=torch.float32,
                      device=chunk.device)
    out[(i + 1) % n] = _dq(q, s)
    for t in range(n - 1):
        q = mesh.ppermute(q, axis, _ring(n))
        s = mesh.ppermute(s, axis, _ring(n))
        # the chunk received belongs to rank (i - t - 1): chunk (i - t)
        out[(i - t) % n] = _dq(q, s)
    return out.reshape(-1)


def compressed_allreduce(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Sum all-reduce over `axis` with int8 wire traffic (ring RS + ring
    AG); every rank of the axis ends with the same tensor."""
    n = mesh.axis_size(axis)
    flat = x.reshape(-1).to(torch.float32)
    pad = (-flat.shape[0]) % n
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    full = ring_all_gather_q(ring_reduce_scatter_q(flat, mesh, axis), mesh,
                             axis)
    if pad:
        full = full[:-pad]
    return full.reshape(x.shape)


def ef_compressed_allreduce(g: torch.Tensor, e: torch.Tensor, mesh,
                            axis: str) -> tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback compressed all-reduce: c = Q(g + e), e' = (g + e) -
    deQ(c); returns (allreduce(deQ(c)), e').  The quantization error stays
    local and is re-injected the next step (Karimireddy et al., 2019)."""
    x = g.to(torch.float32) + e
    q, s = _q(x)
    residual = torch.addcmul(x, q.to(torch.float32), s, value=-1.0)
    return compressed_allreduce(_dq(q, s), mesh, axis), residual


def make_compressed_allreduce_fn(mesh, axis: str = "data"):
    """The compressed all-reduce over one mesh axis as a mean, for
    tensors replicated along `axis` (the reference divides by the axis
    size, which XLA compiles into a multiply by its reciprocal)."""
    inv = torch.tensor(1.0 / mesh.axis_size(axis), dtype=torch.float32)

    def fn(x: torch.Tensor) -> torch.Tensor:
        return compressed_allreduce(x, mesh, axis) * inv.to(x.device)

    return fn
