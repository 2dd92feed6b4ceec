"""Host-side paged-KV bookkeeping: fixed-size pages, free-list
allocation, refcounts, hash-matched prefix sharing, copy-on-write.

The allocator owns NO device memory — it hands out integer page ids
into the `PagedArena` pools and keeps the invariants the device side
relies on:

  * page 0 is the trash page: writes that must be dropped (inactive
    decode lanes, rejected speculative positions, pad lanes) are
    directed there, so every device scatter keeps a static shape;
  * a page a request may WRITE has exactly one referencing table and is
    not in the prefix cache — writable pages are never aliased;
  * prefix-shared and forked pages are read-only while referenced more
    than once; `cow()` resolves a write intent into a fresh page plus a
    (src, dst) device copy;
  * freed pages whose content is still prefix-cached stay reclaimable
    (LRU) instead of free, so a later request with the same prompt
    prefix shares them; allocation pressure reclaims them oldest-first
    (`reclaimed_pages` is the eviction accounting the engine surfaces).

Sharing is *memory* dedup only: a prefix-hit request still computes its
own prefill (token streams must stay independent of cache luck), it
just does not spend pages on positions another request already stores.
Prefix keys include the exact token prefix AND a conditioning digest
(encdec frames / VLM image embeddings change the KV content for the
same tokens), so a hit can never alias semantically different caches.

Pure Python: the port's own copy of the JAX package's allocator, held
to it step for step (`tests/test_torch_paged.py`); `audit()` re-derives
every refcount from scratch so an invariant violation fails loudly.
"""

from __future__ import annotations

import dataclasses

TRASH_PAGE = 0


class PagingError(RuntimeError):
    """Misuse of the allocator (double free, unknown request, ...)."""


@dataclasses.dataclass(frozen=True)
class PageLease:
    """Result of `alloc`: the request's block table (page ids in
    position order) and how much of it was prefix-shared."""
    pages: tuple[int, ...]
    shared_pages: int
    hit_tokens: int


class PageAllocator:
    """Fixed-pool page allocator with refcounts and prefix sharing.

    Args:
      n_pages: total pool pages INCLUDING the reserved trash page 0.
      page_size: KV positions per page.
    """

    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is the trash page)")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1 (got {page_size})")
        self.n_pages = n_pages
        self.page_size = page_size
        self._free = list(range(n_pages - 1, 0, -1))  # stack, low ids first
        self._table_refs = [0] * n_pages
        self._tables: dict[str, list[int]] = {}
        self._cache: dict[tuple, int] = {}       # prefix chain key -> page
        self._cache_key_of: dict[int, tuple] = {}
        self._lru: dict[int, None] = {}          # cached, zero table refs
        self.prefix_hits = 0
        self.hit_tokens = 0
        self.cow_copies = 0
        self.reclaimed_pages = 0
        self.alloc_failures = 0

    # --- capacity ---------------------------------------------------------

    @property
    def usable_pages(self) -> int:
        return self.n_pages - 1

    @property
    def pages_free(self) -> int:
        """Immediately allocatable pages (free + reclaimable cache)."""
        return len(self._free) + len(self._lru)

    @property
    def pages_live(self) -> int:
        return self.usable_pages - len(self._free) - len(self._lru)

    def pages_needed(self, n_positions: int) -> int:
        return -(-max(n_positions, 1) // self.page_size)

    # --- prefix keys ------------------------------------------------------

    def _chain_key(self, digest: str, prompt, i: int) -> tuple:
        end = (i + 1) * self.page_size
        return (digest, i, tuple(prompt[:end]))

    # --- allocation -------------------------------------------------------

    def _reclaim_one(self) -> bool:
        """Evict the oldest reclaimable prefix-cached page to the free
        list.  Returns False when nothing is reclaimable."""
        if not self._lru:
            return False
        page = next(iter(self._lru))
        del self._lru[page]
        key = self._cache_key_of.pop(page)
        del self._cache[key]
        self._free.append(page)
        self.reclaimed_pages += 1
        return True

    def alloc(self, request_id: str, n_positions: int,
              prompt=None, digest: str = "") -> PageLease | None:
        """Reserve the block table for a request needing `n_positions`
        KV slots.  `prompt` (+ `digest`) enables prefix sharing: leading
        FULL pages whose chain key is cached are referenced instead of
        allocated.  Returns None (and counts a failure) when the pool
        cannot cover the non-shared remainder even after reclaiming."""
        if request_id in self._tables:
            raise PagingError(f"request {request_id!r} already holds pages")
        needed = self.pages_needed(n_positions)
        shared: list[int] = []
        if prompt is not None:
            n_full = min(len(prompt) // self.page_size, needed)
            for i in range(n_full):
                page = self._cache.get(self._chain_key(digest, prompt, i))
                if page is None:
                    break
                shared.append(page)
        n_fresh = needed - len(shared)
        # Pin the shared pages BEFORE reclaiming: a shared page with no
        # table refs yet lives on the LRU, exactly where _reclaim_one
        # evicts from — reclaiming first could free-list (and re-pop as
        # "fresh") a page this very request is about to reference.
        for page in shared:
            self._table_refs[page] += 1
            self._lru.pop(page, None)
        while len(self._free) < n_fresh:
            if not self._reclaim_one():
                for page in shared:  # roll back the pins
                    self._drop_ref(page)
                self.alloc_failures += 1
                return None
        fresh = [self._free.pop() for _ in range(n_fresh)]
        for page in fresh:
            self._table_refs[page] = 1
        self._tables[request_id] = shared + fresh
        if shared:
            self.prefix_hits += 1
            self.hit_tokens += len(shared) * self.page_size
        return PageLease(tuple(shared + fresh), len(shared),
                         len(shared) * self.page_size)

    def register_prefix(self, request_id: str, prompt, digest: str = ""
                        ) -> int:
        """Publish the request's fully-written prompt pages into the
        prefix cache (call AFTER the device insert).  Only pages wholly
        covered by the prompt are registered; already-cached chain keys
        are skipped.  Returns the number of newly registered pages."""
        table = self._table(request_id)
        n_full = min(len(prompt) // self.page_size, len(table))
        added = 0
        for i in range(n_full):
            key = self._chain_key(digest, prompt, i)
            if key in self._cache:
                continue
            page = table[i]
            if page in self._cache_key_of:
                continue  # page already published under another key
            self._cache[key] = page
            self._cache_key_of[page] = key
            added += 1
        return added

    # --- release ----------------------------------------------------------

    def _table(self, request_id: str) -> list[int]:
        try:
            return self._tables[request_id]
        except KeyError:
            raise PagingError(
                f"request {request_id!r} holds no pages "
                f"(double free or never allocated)") from None

    def _drop_ref(self, page: int) -> None:
        self._table_refs[page] -= 1
        if self._table_refs[page] < 0:
            raise PagingError(f"page {page} refcount underflow")
        if self._table_refs[page] == 0:
            if page in self._cache_key_of:
                self._lru[page] = None     # reclaimable, keep content
            else:
                self._free.append(page)

    def free(self, request_id: str) -> None:
        """Release every page reference a request holds.  Pages still
        referenced elsewhere (prefix sharing / forks) survive; cached
        pages become reclaimable rather than free."""
        for page in self._table(request_id):
            self._drop_ref(page)
        del self._tables[request_id]

    # --- fork / copy-on-write ---------------------------------------------

    def fork(self, src_id: str, dst_id: str) -> tuple[int, ...]:
        """Share `src_id`'s whole table with a new request (beam /
        parallel-sampling style).  Every page becomes read-only until a
        writer resolves it through `cow`."""
        if dst_id in self._tables:
            raise PagingError(f"request {dst_id!r} already holds pages")
        table = list(self._table(src_id))
        for page in table:
            self._table_refs[page] += 1
            self._lru.pop(page, None)
        self._tables[dst_id] = table
        return tuple(table)

    def writable(self, request_id: str, index: int) -> bool:
        page = self._table(request_id)[index]
        return self._table_refs[page] == 1 and \
            page not in self._cache_key_of

    def cow(self, request_id: str, index: int) -> tuple[int, int] | None:
        """Make table entry `index` writable.  Returns a (src, dst)
        device-copy instruction when the page was shared (the caller
        must copy the content), None when it was already exclusively
        owned.  Raises PagingError when the pool is exhausted."""
        table = self._table(request_id)
        page = table[index]
        if self._table_refs[page] == 1 and page not in self._cache_key_of:
            return None
        while not self._free:
            if not self._reclaim_one():
                self.alloc_failures += 1
                raise PagingError("copy-on-write: pool exhausted")
        fresh = self._free.pop()
        self._table_refs[fresh] = 1
        table[index] = fresh
        self._drop_ref(page)
        self.cow_copies += 1
        return (page, fresh)

    # --- introspection ----------------------------------------------------

    def table(self, request_id: str) -> tuple[int, ...]:
        return tuple(self._table(request_id))

    def holders(self) -> frozenset[str]:
        return frozenset(self._tables)

    def stats(self) -> dict:
        return {
            "n_pages": self.n_pages,
            "page_size": self.page_size,
            "pages_live": self.pages_live,
            "pages_free": len(self._free),
            "pages_cached": len(self._cache),
            "pages_reclaimable": len(self._lru),
            "prefix_hits": self.prefix_hits,
            "prefix_hit_tokens": self.hit_tokens,
            "cow_copies": self.cow_copies,
            "reclaimed_pages": self.reclaimed_pages,
            "alloc_failures": self.alloc_failures,
        }

    def audit(self) -> None:
        """Re-derive every refcount from scratch and assert the full
        invariant set (the hypothesis state machine calls this after
        every step)."""
        counts = [0] * self.n_pages
        for rid, table in self._tables.items():
            assert len(set(table)) == len(table), \
                f"{rid}: duplicate page in table {table}"
            assert TRASH_PAGE not in table, f"{rid}: trash page in table"
            for page in table:
                counts[page] += 1
        assert counts == self._table_refs, \
            f"refcount drift: derived {counts} != {self._table_refs}"
        free_set = set(self._free)
        assert len(free_set) == len(self._free), "duplicate free pages"
        assert TRASH_PAGE not in free_set, "trash page on the free list"
        cached = set(self._cache_key_of)
        assert cached == set(self._cache.values()), "cache maps diverged"
        assert {self._cache_key_of[p]: p for p in cached} == {
            k: p for k, p in self._cache.items()}, "cache key mismatch"
        for page in range(1, self.n_pages):
            is_free = page in free_set
            live = counts[page] > 0 or page in cached
            assert is_free != live, \
                f"page {page}: free={is_free} live={live}"
        assert set(self._lru) == {p for p in cached if counts[p] == 0}, \
            "reclaimable set drift"
        # writable pages are never aliased: one table, not cached
        for rid, table in self._tables.items():
            for i, page in enumerate(table):
                if self.writable(rid, i):
                    others = [r for r, t in self._tables.items()
                              if page in t]
                    assert others == [rid], \
                        f"writable page {page} aliased by {others}"
        # conservation: every table/cache reference is counted exactly
        total_refs = sum(len(t) for t in self._tables.values()) + len(cached)
        assert sum(counts) + len(cached) == total_refs
