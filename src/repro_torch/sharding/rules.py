"""Parameter / batch / cache partition rules for every architecture.

The JAX package's rules (Megatron-style TP on the "model" axis, optional
ZeRO-3/FSDP weight sharding on the "data" axis, EP for MoE experts,
pod-composed data parallelism on the multi-pod mesh), written as pure
functions of shapes and a mesh's axis sizes.  A spec is a tuple with one
entry per dimension: a mesh axis name, a tuple of axis names, or None
(replicated).  Every rule passes through a divisibility check: an axis
that does not divide the dimension is dropped, which is what makes one
rule set valid for all 10 architectures (kv_heads=4 on a model=16 axis,
8 experts on 16-way model parallelism).

`mesh` is anything with a `shape` mapping of axis name -> size and
`axis_names` (`launch.mesh.Mesh`, or an abstract one from
`launch.mesh.make_abstract_mesh`): the rules need no process group.

What the port places by these rules: `init_cache` keeps the rank's slice
of every cache leaf `cache_pspec` puts on "model" (the K/V heads of a
head-sharded attention), and the paged arena's pools follow it
(`paged_pool_pspec`).  A serving engine whose capacity the dp axes divide
gives each data rank its block of the slots (`batch_pspec` on the slot
dim, `local_rows`): every decode-cache leaf keeps the rank's rows by
`cache_pspec` (`api.init_cache(split_rows=True)`), and so does the
per-slot sampler state; the pools' page rows stay whole.  Serving's GEMM weights are split by the GEMM's own
column rule (`approx.gemm`: every approximate GEMM whose output dimension
divides the model axis runs column-parallel), which is where the JAX
package's computation puts them whatever `param_pspec` says of storage;
`param_pspec` is kept for the sharded train step.
"""

from __future__ import annotations

import math
from typing import Any

Spec = tuple


class Attr(str):
    """A path part naming a `PreparedWeight` field (an attribute), not a
    dict key: such parts inherit the enclosing leaf's rule."""


def _axis_sizes(mesh) -> dict[str, int]:
    return dict(mesh.shape)


def normalize(spec) -> Spec:
    """A spec with each one-axis tuple entry as its axis name (the JAX
    package's PartitionSpec does the same: ("data",) reads "data")."""
    return tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a
                 for a in spec)


def dp_axes(mesh):
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def logical_rules(mesh, fsdp: bool = True) -> dict[str, Any]:
    """Rules for activation hints (sharding/ctx.py)."""
    return {
        "batch": dp_axes(mesh),
        "heads": "model",
        "kv_heads": "model",
        "ff": "model",
        "vocab": "model",
        "experts": "model",
        "embed": None,
        "seq": None,
    }


def _fits(dim: int, mesh, axis) -> bool:
    if axis is None:
        return True
    axes = axis if isinstance(axis, tuple) else (axis,)
    sizes = _axis_sizes(mesh)
    return dim % math.prod(sizes[a] for a in axes) == 0


def _clean(spec_axes: list, shape: tuple[int, ...], mesh) -> Spec:
    return tuple(ax if _fits(dim, mesh, ax) else None
                 for dim, ax in zip(shape, spec_axes))


def _param_rules(fsdp_ax) -> dict[str, list]:
    """Core-dimension rules per parameter name, for the trailing dims;
    leading stack dims (layer / superblock) get None."""
    col = [fsdp_ax, "model"]     # (in, out) column-parallel
    row = ["model", fsdp_ax]     # (in, out) row-parallel
    return {
        # embeddings / heads
        "embed": ["model", None],
        "lm_head": col,
        "dec_pos": [None, None],
        # attention (incl. whisper x-prefixed and vlm cross)
        "wq": col, "wk": col, "wv": col, "wo": row,
        "xwq": col, "xwk": col, "xwv": col, "xwo": row,
        # dense mlp
        "w_gate": col, "w_up": col, "w_down": row,
        "m_gate": col, "m_up": col, "m_down": row,
        # moe
        "router": [fsdp_ax, None],
        "we_gate": ["model", fsdp_ax, None],
        "we_up": ["model", fsdp_ax, None],
        "we_down": ["model", None, fsdp_ax],
        # mamba2: only the input projection is TP-sharded (the JAX
        # package's partitioner miscompiles a channel-sharded conv and a
        # row-parallel out_proj); out_proj keeps its ZeRO-3 sharding
        "in_proj": col, "out_proj": [None, fsdp_ax],
        # rg-lru
        "w_x": col, "w_gate_br": col, "w_rg": col, "w_in": col,
        "w_out": row,
    }


def _moe_fallback(name: str, shape: tuple[int, ...], mesh, fsdp_ax
                  ) -> Spec | None:
    """Experts not divisible by the model axis -> TP inside each expert."""
    if name in ("we_gate", "we_up") and not _fits(shape[-3], mesh, "model"):
        return _clean([None, fsdp_ax, "model"], shape[-3:], mesh)
    if name == "we_down" and not _fits(shape[-3], mesh, "model"):
        return _clean([None, "model", fsdp_ax], shape[-3:], mesh)
    return None


#: `PreparedWeight` fields: path parts that are attributes (`Attr`) with
#: these names take the enclosing leaf's rule.  w / wq / planes carry the
#: (..., k, n) core dims, sw is (..., 1, n) and wq_t (..., n, k), the
#: K-major copy, whose rule is wq's with the last two entries swapped.
_PREPARED_ATTRS = frozenset({"w", "wq", "wq_t", "sw", "planes"})


def leaf_name(path: tuple) -> tuple[str | None, bool]:
    """(the name a param leaf's rule is looked up by, whether the leaf is
    a K-major copy): the last path part that is neither an int8 {"q",
    "s"} wrapper level nor a `PreparedWeight` field.  `param_pspec` and
    the coverage checker (`repro_torch.analysis.coverage`) both walk paths
    through it."""
    kmajor = False
    for part in reversed(path):
        key = str(part)
        if key in ("q", "s"):
            continue
        if isinstance(part, Attr) and key in _PREPARED_ATTRS:
            kmajor = kmajor or key == "wq_t"
            continue
        return key, kmajor
    return None, kmajor


def param_pspec(path: tuple, arr_shape: tuple[int, ...], mesh,
                fsdp: bool = True) -> Spec:
    """Spec of a param leaf at `path` (dict keys as str, `PreparedWeight`
    fields as `Attr`); int8 {"q", "s"} wrapper levels are skipped."""
    fsdp_ax = "data" if fsdp else None
    name, kmajor = leaf_name(path)
    rules = _param_rules(fsdp_ax)
    if name not in rules:
        return ()  # norms, scalars, biases, gates: replicated
    core = rules[name]
    ncore = len(core)
    if len(arr_shape) < ncore:
        return ()
    shape = tuple(arr_shape)
    if kmajor:
        shape = (*shape[:-2], shape[-1], shape[-2])
    moe_alt = _moe_fallback(name, shape, mesh, fsdp_ax)
    if moe_alt is not None:
        core_spec = list(moe_alt)
    else:
        core_spec = list(_clean(core, shape[-ncore:], mesh))
    spec = [None] * (len(shape) - ncore) + core_spec
    if kmajor:
        spec[-2], spec[-1] = spec[-1], spec[-2]
    return tuple(spec)


def tree_paths(tree: Any, prefix: tuple = ()):
    """(path, tensor) of every tensor leaf of a params tree: dict keys as
    str, `PreparedWeight` fields as `Attr` (a None wq_t skipped)."""
    from repro_torch.approx import gemm as gemm_mod
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_paths(v, (*prefix, str(k)))
    elif gemm_mod.is_prepared(tree):
        for f in ("w", "wq", "sw", "planes", "wq_t"):
            leaf = getattr(tree, f)
            if leaf is not None:
                yield (*prefix, Attr(f)), leaf
    elif hasattr(tree, "shape"):
        yield prefix, tree


def param_specs(tree: Any, mesh, fsdp: bool = True) -> dict:
    """{path: spec} over every tensor leaf of a params tree."""
    return {path: param_pspec(path, tuple(leaf.shape), mesh, fsdp)
            for path, leaf in tree_paths(tree)}


# --- batches ------------------------------------------------------------------

def batch_pspec(name: str, shape: tuple[int, ...], mesh) -> Spec:
    dp = dp_axes(mesh)
    if not shape:
        return ()
    return normalize((dp if _fits(shape[0], mesh, dp) else None,
                      *([None] * (len(shape) - 1))))


# --- decode caches --------------------------------------------------------------

# batch-dim position per cache key (negative = from the end)
_CACHE_BATCH_DIM = {
    "k": -4, "v": -4, "xk": -4, "xv": -4,
    "conv": 1, "ssm": 1,
    "rec_conv": 2, "rec_lru": 2, "att_k": 1, "att_v": 1,
    "tail_conv": 1, "tail_lru": 1,
}
# kv-head dims additionally on "model" where they exist (the mamba2 "ssm"
# state is deliberately absent: the SSD recurrence runs replicated)
_CACHE_MODEL_DIM = {"k": -2, "v": -2, "xk": -2, "xv": -2,
                    "att_k": -2, "att_v": -2}


def cache_pspec(key: str, shape: tuple[int, ...], mesh) -> Spec:
    if key == "length" or not shape:
        return ()
    dp = dp_axes(mesh)
    spec: list = [None] * len(shape)
    bpos = _CACHE_BATCH_DIM.get(key)
    if bpos is not None:
        bpos = bpos % len(shape)
        if _fits(shape[bpos], mesh, dp):
            spec[bpos] = dp
    mpos = _CACHE_MODEL_DIM.get(key)
    if mpos is not None:
        mpos = mpos % len(shape)
        if spec[mpos] is None and _fits(shape[mpos], mesh, "model"):
            spec[mpos] = "model"
    return normalize(spec)


def paged_pool_pspec(key: str, shape: tuple[int, ...], mesh) -> Spec:
    """Spec of a paged-KV pool leaf (serving/arena.PagedArena): pools have
    no per-slot batch axis, and the global page-rows axis stays replicated
    (traffic-dependent tables index it); the kv-head dim keeps the dense
    cache leaf's rule, so a TP mesh shards paged KV as it shards slot KV."""
    if key == "length" or not shape:
        return ()
    spec: list = [None] * len(shape)
    mpos = _CACHE_MODEL_DIM.get(key)
    if mpos is not None:
        mpos = mpos % len(shape)
        if _fits(shape[mpos], mesh, "model"):
            spec[mpos] = "model"
    return tuple(spec)


def local_shape(shape: tuple[int, ...], spec: Spec, mesh,
                axes: tuple[str, ...] | None = None) -> tuple[int, ...]:
    """One rank's block of a tensor of `shape` under `spec`, splitting
    over the spec's axes that are among `axes` (None: all of them).  A
    model family passes ("model",): the rows of the batch it is given are
    its caller's to split (`api.init_cache`)."""
    sizes = _axis_sizes(mesh)
    axes = tuple(sizes) if axes is None else axes
    out = []
    for dim, ax in zip(shape, tuple(spec) + (None,) * len(shape)):
        names = ax if isinstance(ax, tuple) else (ax,)
        div = math.prod(sizes[a] for a in names if a in axes)
        out.append(dim // div)
    return tuple(out)


def local_rows(batch: int, mesh) -> int:
    """One data rank's rows of a batch dim of `batch` rows: its block over
    the dp axes where their size divides `batch` (`batch_pspec`), else
    every row."""
    return local_shape((batch,), batch_pspec("rows", (batch,), mesh),
                       mesh)[0]


def should_fsdp(cfg) -> bool:
    """ZeRO-3 weight sharding on the data axis for >=20B-param configs."""
    return cfg.param_count() >= 20e9


# --- rule introspection ---------------------------------------------------------

def known_param_rule_names() -> frozenset[str]:
    """Param leaf names with an explicit partition rule."""
    return frozenset(_param_rules(None))


def known_cache_keys() -> frozenset[str]:
    """Decode-cache keys with a batch-dim rule ("length" is handled as an
    explicit replicated special case in cache_pspec)."""
    return frozenset(_CACHE_BATCH_DIM) | {"length"}
