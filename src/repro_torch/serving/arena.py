"""Decode-state arenas: the slot arena and the paged arena.

`SlotArena` is the model's decode cache allocated once at `capacity` slots
(every leaf of `api.init_cache` at the capacity, and a per-slot
(capacity,) length).  Admitting a request copies every leaf of its
single-row prefill cache into a free slot in place, along the leaf's slot
axis, which is found structurally.

`PagedArena` keeps the cache leaves that scale with `max_len` as page
pools addressed through per-request block tables (the paged engine's
layout); every other leaf (SSM states, conv tails, attention rings, the
lengths) stays a dense per-slot leaf.

Under a mesh the engines build their arena inside the mesh's rules, so
`api.init_cache` (and the meta probes) give each rank its heads of the
K/V leaves: slot leaves and pools hold the rank's kv heads, the split
`sharding.rules.cache_pspec` / `paged_pool_pspec` describe.  With
`split_rows` (a data rank serving its block of the slots) every slot
leaf and the lengths hold the rank's `rows` only (`cache_pspec`'s batch
dim on the dp axes), while the pools keep every page row
(`paged_pool_pspec`): tables index them with any slot's pages.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import api
from repro_torch.sharding import ctx, rules


def _rows(capacity: int, split_rows: bool) -> int:
    """The slots an arena of `capacity` holds: this data rank's block
    under the active mesh with `split_rows`, else all of them."""
    mesh = ctx.active_mesh()
    if not split_rows or mesh is None:
        return capacity
    return rules.local_rows(capacity, mesh)


def _probe(cfg: ModelConfig, batch: int, length: int,
           split_rows: bool = False) -> dict:
    """The decode cache's shapes at `batch` and `length`, on the meta
    device, with the per-slot (rows,) length the arenas keep."""
    meta = torch.device("meta")
    cache = api.init_cache(cfg, batch, length, meta, split_rows=split_rows)
    cache["length"] = torch.zeros((_rows(batch, split_rows),),
                                  dtype=torch.int32, device=meta)
    return cache


def _slot_axes(cfg: ModelConfig, max_len: int) -> dict[str, int]:
    """Each leaf's slot axis, probed at batch 1 against batch 2 (so a
    capacity-1 arena has one too)."""
    one, two = _probe(cfg, 1, max_len), _probe(cfg, 2, max_len)
    if set(one) != set(two):
        raise ValueError("cache keys depend on the batch size")
    return {key: _slot_axis(one[key].shape, two[key].shape) for key in one}


class SlotArena:
    """The batched decode cache; `cache["length"]` is per-slot.  With
    `split_rows` it holds this data rank's `rows` slots (module
    docstring), indexed from 0."""

    def __init__(self, cfg: ModelConfig, capacity: int, max_len: int,
                 device: torch.device, split_rows: bool = False):
        self.cfg, self.capacity, self.max_len = cfg, capacity, max_len
        self.rows = _rows(capacity, split_rows)
        cache = api.init_cache(cfg, capacity, max_len, device,
                               split_rows=split_rows)
        cache["length"] = torch.zeros((self.rows,), dtype=torch.int32,
                                      device=device)
        self.cache = cache
        self.slot_axes = _slot_axes(cfg, max_len)

    def insert(self, req_cache: dict, slot: int) -> None:
        """Copy every leaf of a 1-row prefill cache (built with
        max_len=self.max_len and a true_len vector) into `slot` (a row of
        this arena)."""
        for key, c in self.cache.items():
            dst = c.narrow(self.slot_axes[key], slot, 1)
            dst.copy_(req_cache[key].reshape(dst.shape))


def _slot_axis(req_shape: tuple, arena_shape: tuple) -> int:
    """Axis along which a 1-row request cache stacks into the arena."""
    if len(req_shape) != len(arena_shape):
        raise ValueError(f"cache rank mismatch: {req_shape} vs {arena_shape}")
    for i, (r, a) in enumerate(zip(req_shape, arena_shape)):
        if r != a:
            if r != 1:
                raise ValueError(
                    f"non-slot axis differs: {req_shape} vs {arena_shape}")
            return i
    return 0  # capacity == 1: a full overwrite along any axis is exact


class PagedArena:
    """Paged decode state.  Cache leaves that scale with `max_len` become
    page POOLS — one global rows axis of `n_pages * page_size` positions —
    addressed through per-request block tables; every other leaf (SSM
    states, conv tails, attention rings, the per-slot lengths) stays a
    dense per-slot leaf.

    Which leaves page is discovered structurally, never by name: a leaf
    pages iff probing `api.init_cache` (on the meta device) at `max_len`
    and `2 * max_len` moves exactly one axis from `max_len` to
    `2 * max_len`, and that axis sits right after the slot axis.  The
    slot axis is probed at batch 1 against batch 2, so a capacity-1 arena
    pages too (the JAX package probes at the capacity, finds no slot axis
    at capacity 1 and keeps every leaf dense there).

    Decode reads the pools through `view()`, a gather into fresh tensors
    that reconstructs the dense (capacity, max_len) cache the slot decode
    consumes, so the model's in-place K/V writes land in the view and never
    in a pool.  The view's dense leaves are the arena's own tensors: the
    engine copies them wherever a step must not advance them.
    `scatter_rows()` commits one written view row per slot back to the
    pools; a write that must be dropped (an idle lane, a rejected
    speculative position) goes to flat row 0, the trash page.  Pools start
    at zero and receive only finite K/V: masked attention lanes contribute
    exactly 0 only while stale rows stay finite.
    """

    TRASH_FLAT = 0   # flat row 0 == page 0: the write sink

    def __init__(self, cfg: ModelConfig, capacity: int, max_len: int,
                 page_size: int, n_pages: int, device: torch.device,
                 split_rows: bool = False):
        self.cfg, self.capacity, self.max_len = cfg, capacity, max_len
        self.page_size, self.n_pages = page_size, n_pages
        self.device = device
        self.rows = _rows(capacity, split_rows)
        self.max_pages = -(-max_len // page_size)  # table width
        self.slot_axes = _slot_axes(cfg, max_len)
        dense = _probe(cfg, capacity, max_len, split_rows)
        two, big = _probe(cfg, 2, max_len), _probe(cfg, 2, 2 * max_len)
        if not set(dense) == set(self.slot_axes) == set(big):
            raise ValueError("cache keys depend on batch/max_len")
        self.paged: dict[str, int] = {}   # key -> pool rows axis
        cache = {}
        for key in sorted(dense):
            a, g = two[key].shape, big[key].shape
            sax = self.slot_axes[key]
            grew = [i for i, (x, y) in enumerate(zip(a, g)) if x != y]
            if (key != "length" and len(grew) == 1
                    and a[grew[0]] == max_len and g[grew[0]] == 2 * max_len
                    and grew[0] == sax + 1):
                shape = a[:sax] + (n_pages * page_size,) + a[sax + 2:]
                self.paged[key] = sax   # batch axis removed: rows at sax
            else:
                shape = dense[key].shape
            cache[key] = torch.zeros(shape, dtype=dense[key].dtype,
                                     device=device)
        self.cache = cache

    def view(self, cache: dict, table: torch.Tensor) -> dict:
        """Gather the dense (capacity, max_len) per-slot cache the slot
        decode consumes, into fresh tensors.  Rows of unreserved table
        entries alias the trash page — harmless, they sit past `length`."""
        ps = self.page_size
        j = torch.arange(self.max_len, device=table.device)
        idx = table[:, j // ps] * ps + (j % ps)[None, :]   # (cap, max_len)
        out = dict(cache)
        for key, axis in self.paged.items():
            pool = cache[key]
            rows = pool.index_select(axis, idx.reshape(-1))
            out[key] = rows.unflatten(axis, idx.shape)
        return out

    def flat_rows(self, table: torch.Tensor, pos: torch.Tensor,
              valid: torch.Tensor) -> torch.Tensor:
        """Pool row of each lane's position; the trash row where `valid`
        is False or the position lies past the table."""
        ps = self.page_size
        ok = valid & (pos < self.max_len)
        p = torch.clamp(pos, 0, self.max_len - 1).long()
        lanes = torch.arange(table.shape[0], device=table.device)
        page = table[lanes, p // ps]
        return torch.where(ok, page * ps + p % ps,
                           torch.full_like(page, self.TRASH_FLAT))

    def rows_at(self, view: dict, pos: torch.Tensor) -> dict:
        """Each lane's view row at `pos` (lanes,) of every paged leaf, the
        lanes leading: {key: (lanes, ...)}."""
        p = torch.clamp(pos, 0, self.max_len - 1).long()
        lanes = torch.arange(pos.shape[0], device=pos.device)
        return {key: view[key].movedim((axis, axis + 1), (0, 1))[lanes, p]
                for key, axis in self.paged.items()}

    def put_rows(self, cache: dict, flat: torch.Tensor, rows: dict) -> None:
        """Write `rows` ({key: (n, ...)}, `rows_at`'s layout) to the pool
        rows `flat` (n,), in place.  Several of them may be the trash row
        (which one lands is unspecified, and only there); a live row is
        written at most once."""
        for key, axis in self.paged.items():
            r = rows[key].movedim(0, axis)            # lanes at the rows axis
            cache[key].index_copy_(axis, flat, r.to(cache[key].dtype))

    def scatter_rows(self, cache: dict, view: dict, table: torch.Tensor,
                     pos: torch.Tensor, valid: torch.Tensor) -> None:
        """Commit, per slot, the single view row at `pos` (capacity,) into
        the pools, in place; slots with `valid` False write the trash page
        instead.  Only paged leaves change."""
        self.put_rows(cache, self.flat_rows(table, pos, valid),
                      self.rows_at(view, pos))

    def insert(self, req_cache: dict, slot: int | None,
               flat_idx: torch.Tensor) -> None:
        """Admit a 1-row prefill/workspace cache: paged leaves scatter
        their `max_len` rows to `flat_idx` (host-built: prefix-shared and
        unwritten positions point at the trash page, so read-only pages
        are never touched and fresh pages stay zero past the prompt); slot
        leaves copy into `slot`, a row of this arena (None: another data
        rank holds the slot, and only the pools change)."""
        for key, c in self.cache.items():
            r = req_cache[key]
            if key in self.paged:
                axis = self.paged[key]
                c.index_copy_(axis, flat_idx, r.squeeze(axis).to(c.dtype))
            elif slot is not None:
                c.narrow(self.slot_axes[key], slot, 1).copy_(r)

    def copy_pages(self, src, dst) -> None:
        """Page-granular pool copy (copy-on-write): page `src[i]` to
        `dst[i]`."""
        dev = self.device
        src = torch.as_tensor(src, dtype=torch.long).to(dev,
                                                        non_blocking=True)
        dst = torch.as_tensor(dst, dtype=torch.long).to(dev,
                                                        non_blocking=True)
        for key, axis in self.paged.items():
            pages = self.cache[key].unflatten(
                axis, (self.n_pages, self.page_size))
            pages.index_copy_(axis, dst, pages.index_select(axis, src))
