"""Pipeline parallelism: GPipe-style micro-batch streaming over a "stage"
mesh axis, the counterpart of the JAX package's `repro.sharding.pipeline`
(there `shard_map` + `lax.ppermute`; here one process per stage and
`Mesh.ppermute`).

The fill-drain schedule runs M micro-batches over S stages in M + S - 1
ticks (bubble fraction (S - 1) / (M + S - 1)): at tick t stage 0 takes
micro-batch t, every other stage the output stage i - 1 sent it at tick
t - 1; the last stage's output at tick t is micro-batch t - (S - 1).  At
the end the last stage's outputs go to every stage (a sum over the axis
of the last stage's outputs and the others' zeros).  Each stage computes
`stage_fn` on the tensors the sequential composition would, so the
result has its bits.

Forward only: an input that needs a gradient raises (the schedule's
transfers record no autograd edge).
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.train.optimizer import tree_leaves, tree_map


def pipeline_apply(stage_fn: Callable, stage_params: Any,
                   x_mb: torch.Tensor, mesh, axis: str = "stage"
                   ) -> torch.Tensor:
    """Run `stage_fn(params_i, x)` as a pipeline over `mesh`'s `axis`.

    stage_params: a tensor, or a dict tree of them, with leading dim S
    (this rank takes its stage's slice); x_mb: (M, mb, d) micro-batches,
    the same on every rank.  Returns the (M, mb, d) outputs on every
    rank."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in [x_mb, *tree_leaves(stage_params)]):
        raise NotImplementedError(
            "pipeline_apply is forward only: its stage-to-stage transfers "
            "record no gradient")
    s = mesh.axis_size(axis)
    idx = mesh.axis_index(axis)
    m = x_mb.shape[0]
    local = tree_map(lambda p: p[idx], stage_params)
    forward = [(i, i + 1) for i in range(s - 1)]
    buf = torch.zeros_like(x_mb[0])
    outs = torch.zeros_like(x_mb)
    for t in range(m + s - 1):
        y = stage_fn(local, x_mb[min(t, m - 1)] if idx == 0 else buf)
        out_idx = t - (s - 1)
        if idx == s - 1 and 0 <= out_idx < m:
            outs[out_idx] = y
        buf = mesh.ppermute(y, axis, forward)
    if idx != s - 1:
        outs.zero_()
    return mesh.all_reduce(outs, axis)


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    return (n_stages - 1) / (n_microbatches + n_stages - 1)
