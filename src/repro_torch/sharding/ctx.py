"""The active mesh and its logical-axis rules.

Models are written against *logical* axis names ("batch", "heads", "ff",
"experts", ...).  A serving step activates a mesh and a rule set with
`use_rules`; the approximate GEMMs read `active()` to run column-parallel
over the mesh's "model" axis, and the transformer to run its attention
on the rank's heads.  Outside any context (unit tests, one-device runs)
nothing is sharded, so model code never depends on distribution state.

A rule maps logical axis -> mesh axis (or tuple of mesh axes, or None).
`spec_for` drops a mapping whenever the dimension is not divisible by the
mesh axes' total size (e.g. kv_heads=4 on a model=16 axis).

`row_block` names a data rank's rows of a serving step (`whole_rows`):
the engines enter it around each decode step of a rank that holds a
block of the slots, and the norms and decode attention run the rows
among zero rows of the whole count (`models.common.on_whole_rows`), so
their kernels see one device's shapes.

`hint` returns its input.  In the JAX package it is a sharding
constraint for the compiler's partitioner; the port has none: every rank
is a one-device program and placement is explicit (each rank holds its
slice of what is split, and the GEMMs gather what a later op needs
whole), so there is nothing to hint.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any

_ACTIVE: list[tuple[Any, dict[str, Any]]] = []
_ROWS: list[tuple[int, int]] = []


@contextlib.contextmanager
def use_rules(mesh, rules: dict[str, Any]):
    _ACTIVE.append((mesh, rules))
    try:
        yield
    finally:
        _ACTIVE.pop()


@contextlib.contextmanager
def whole_rows(first: int, whole: int):
    """Within: the decode steps run a data rank's rows, which start at
    row `first` of `whole` (module docstring)."""
    _ROWS.append((first, whole))
    try:
        yield
    finally:
        _ROWS.pop()


def row_block() -> tuple[int, int] | None:
    """(first row, whole row count) of the active `whole_rows`, or None."""
    return _ROWS[-1] if _ROWS else None


def active() -> tuple[Any, dict[str, Any]] | None:
    return _ACTIVE[-1] if _ACTIVE else None


def active_mesh():
    """The active mesh, or None outside a context."""
    return _ACTIVE[-1][0] if _ACTIVE else None


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        return math.prod(mesh.shape[a] for a in axis)
    return mesh.shape[axis]


def spec_for(shape: tuple[int, ...], logical: tuple[str | None, ...],
             mesh, rules: dict[str, Any]) -> tuple:
    assert len(shape) == len(logical), (shape, logical)
    out = []
    used: set = set()
    for dim, name in zip(shape, logical):
        axis = rules.get(name) if name else None
        if axis is not None and dim % _axis_size(mesh, axis) != 0:
            axis = None  # not divisible -> replicate this dim
        if axis is not None:
            flat = tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)
            if any(a in used for a in flat):
                axis = None  # a mesh axis can appear at most once per spec
            else:
                used.update(flat)
        out.append(axis)
    from repro_torch.sharding.rules import normalize
    return normalize(out)


def hint(x, *logical: str | None):
    """Identity: placement in the port is explicit (module docstring)."""
    return x
