"""Paged-KV serving engine: block tables + chunked prefill + approx-draft
speculative decoding.

`PagedEngine` subclasses the slot `Engine` and replaces only the
device-state layout and the per-tick admission and decode; submission
validation, tier ladders, deadlines and eviction accounting are
inherited.  Three capabilities stack, each optional but the first:

  1. **Paged KV** (always on): the `max_len`-scaling cache leaves live in
     global page pools (`PagedArena`); a host-side `PageAllocator` hands
     out block tables with reserve-ahead allocation (every page a request
     can ever touch is reserved at admission, so decode never runs out of
     pages mid-request), prefix sharing and copy-on-write bookkeeping.
     Each step gathers a dense per-slot view that holds, at every valid
     position, exactly what the slot arena holds, so paged serving emits
     exactly the tokens the slot engine emits.  Leaves that do not scale
     with `max_len` (SSM states, conv tails, the hybrid's attention rings)
     stay dense per-slot leaves: a decode step commits them whole, the
     draft runs on copies, and verify keeps a per-step snapshot of them
     and sets each lane to its snapshot at its last emitted position, as
     the JAX package's `_sel` / `_pick_snap` do.  Dense leaves that decode
     never writes (`api.static_cache_keys`: encdec's cross K/V) are
     neither copied nor snapshotted.  The prefix-cache key joins the
     request's conditioning (`_conditioning_digest`): equal tokens under
     other frames or images are other K/V.
  2. **Chunked prefill** (`prefill_chunk=c`): prompts longer than `c`
     prefill in `c`-token chunks, at most `chunk_budget` chunks per tick,
     interleaved with decode.  The first chunk is a `prefill` of `c`
     tokens, the rest are `api.chunk_step`, a loop of the model's own
     `decode_step`.
  3. **Speculative decoding** (`draft_tier=name`): an approximate
     multiplier tier drafts `spec_k` greedy tokens on a throwaway view;
     the serving tier re-runs them in one verify loop and emits the
     longest agreeing prefix plus one correction.  Rejected positions are
     scattered to the trash page — they never enter the KV pools — and
     `Completion.spec` carries the proposed/accepted/corrections audit
     (`accepted + corrections == len(tokens)` by construction).  Sampled
     (temperature > 0) rows bypass speculation: they emit one token per
     step, drawn once from the row's own generator as the slot engine
     draws it, so seeded sampling stays token-identical too.

Data parallelism (the slot engine's row split, `serving/engine.py`): a
data rank's dense leaves, lengths and table rows are its slots' rows,
while the pools keep every page row on every rank, as
`sharding.rules.paged_pool_pspec` says.  Prefill and chunked-prefill
jobs run whole on every rank, so each rank writes every prompt's pages
itself (a prefix hit reads the same bits on every rank); a decode,
draft or verify step runs on the rank's rows, and the K/V rows it
commits (with their pool rows) are all-gathered over the dp axes before
the write, so every rank's pools take every lane's rows.  Speculation's
per-lane results (emitted tokens, counts) are all-gathered likewise,
and every rank's host loop emits and audits every slot.

Token identity with the slot engine rests on: masked attention lanes
contribute exactly 0 (-1e30 under softmax; pools only ever hold finite
K/V), the draft, verify and chunk loops run the same `decode_step` the
slot engine runs, every op of a decode step is per-row (the GEMM
quantizes rows and sums exactly in int32), greedy rows never draw from a
generator and sampled rows draw once per emitted token in both engines.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import api
from repro_torch.serving import sampling
from repro_torch.serving.arena import PagedArena
from repro_torch.serving.engine import Engine, _Slot
from repro_torch.serving.paging import (
    PageAllocator, PageLease, PagingError, TRASH_PAGE)
from repro_torch.serving.types import Request, SpecStats


def _sync(device: torch.device) -> None:
    """Wait for the device, so a host clock reading covers its work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)  # analysis: allow[JH101] a prefill chunk's host clock covers its device work (the meter prices it)


class _PagedSlot(_Slot):
    """A slot record with the paged engine's own state: whether it is
    still prefilling in chunks (it holds a slot and pages, but does not
    decode or emit yet), and its speculation counters ({"proposed",
    "accepted", "corrections"}; None when the engine does not speculate,
    and then `Completion.spec` is None)."""

    def __init__(self, *args, speculating: bool, prefilling: bool = False):
        super().__init__(*args)
        self.prefilling = prefilling
        self.spec_counts: dict[str, int] | None = (
            {"proposed": 0, "accepted": 0, "corrections": 0}
            if speculating else None)


@dataclasses.dataclass
class _ChunkJob:
    """A request mid-chunked-prefill: holds the single-row workspace
    cache between ticks (its slot and pages are already reserved)."""
    request: Request
    slot_id: int
    lease: PageLease
    digest: str
    gen: torch.Generator
    extras: dict
    workspace: dict
    pos: int


class PagedEngine(Engine):
    """Paged + chunked + speculative continuous-batching engine.

    Extra args on top of `Engine`:
      page_size: KV positions per page.
      n_pages: pool pages incl. the trash page; the default sizes the pool
        so full occupancy at max_len always fits
        (capacity * ceil(max_len / page_size) + 1).
      prefill_chunk: chunk length for interleaved prefill; None/0 keeps
        the slot engine's whole-prompt prefill-then-join admission.
      chunk_budget: prefill chunks advanced per tick (oldest job first).
      draft_tier: multiplier-tier name drafting speculative tokens (e.g.
        "trunc4x4"; the serving tier itself gives the 100%-acceptance
        identity draft).  None disables speculation.
      spec_k: draft tokens proposed per speculative step.
      prefix_cache: hash-matched prompt-prefix page sharing on/off.
    """

    #: The slot engine's, and: a chunk of a chunked prefill waits for the
    #: device so its host clock covers it (`_sync`; the last chunk's
    #: first-token read waits instead); a verify step reads its verdicts
    #: (`_verify`); the draft steps read nothing.
    HOST_SYNCS = {"decode": 1, "prefill": 1, "chunk": 1, "draft": 0,
                  "verify": 1}

    def __init__(self, cfg: ModelConfig, params=None, *,
                 page_size: int = 16, n_pages: int | None = None,
                 prefill_chunk: int | None = None, chunk_budget: int = 1,
                 draft_tier: str | None = None, spec_k: int = 4,
                 prefix_cache: bool = True, **kw):
        capacity = kw.get("capacity", 4)
        max_len = kw.get("max_len", 256)
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1 (got {page_size})")
        if prefill_chunk is not None and prefill_chunk < 1:
            prefill_chunk = None
        if draft_tier is not None and spec_k < 1:
            raise ValueError(f"spec_k must be >= 1 (got {spec_k})")
        self.page_size = page_size
        self.n_pages = (n_pages if n_pages is not None
                        else capacity * (-(-max_len // page_size)) + 1)
        self.prefill_chunk = prefill_chunk
        self.chunk_budget = max(1, chunk_budget)
        self.draft_tier = draft_tier
        self.spec_k = spec_k
        self.prefix_cache = prefix_cache
        super().__init__(cfg, params, **kw)
        self._alloc = PageAllocator(self.n_pages, page_size)
        self._jobs: list[_ChunkJob] = []
        self._leases: dict[str, PageLease] = {}
        #: conditioning digests of queued requests, dropped at admission
        self._digests: dict[str, str] = {}
        self._paged_stalls = 0
        self._chunks = 0
        self._chunk_s = 0.0
        self._spec_steps = 0
        self._spec_totals = {"proposed": 0, "accepted": 0, "corrections": 0}
        if draft_tier is not None:
            if draft_tier in self._tier_specs:
                self._draft_spec = self._tier_specs[draft_tier]
                self._draft_exec = self._tier_exec[draft_tier]
            else:
                self._draft_spec = api.make_spec(cfg, mult=draft_tier,
                                                 device=self.device)
                self._draft_exec = (
                    self.params if self._draft_spec is None
                    else api.prepare_params(self.params, cfg,
                                            self._draft_spec,
                                            mesh=self.mesh))

    # --- device state -----------------------------------------------------

    def _build_state(self) -> None:
        capacity = self.capacity
        self._arena = PagedArena(self.cfg, capacity, self.max_len,
                                 self.page_size, self.n_pages, self.device,
                                 split_rows=self.split_rows)
        # every slot's block table (host-built at admission, alike on
        # every rank); `_table` is this rank's rows of it, a view
        self._table_all = torch.zeros((capacity, self._arena.max_pages),
                                      dtype=torch.int64, device=self.device)
        self._table = self._table_all[self._lo:self._lo + self._rows]
        # the leaves that do not page and that decode writes, besides the
        # lengths
        self._dense = sorted(set(self._arena.cache) - set(self._arena.paged)
                             - {"length"} - api.static_cache_keys(self.cfg))
        self._all_lanes = torch.ones((self._rows,), dtype=torch.bool,
                                     device=self.device)
        self._init_lanes()

    # --- submission / admission -------------------------------------------

    def submit(self, request: Request) -> None:
        sp = request.sampling
        n = len(request.tokens)
        if n >= 1 and sp.max_new_tokens >= 1:
            need = -(-(n + sp.max_new_tokens - 1) // self.page_size)
            if need > self.n_pages - 1:
                raise ValueError(
                    f"{request.request_id}: needs {need} pages, pool has "
                    f"{self.n_pages - 1} usable")
        super().submit(request)

    def _conditioning_digest(self, request: Request) -> str:
        """Prefix-cache key component: each extras key with its array's
        shape, dtype and the sha1 of its raw bytes (frames and image
        embeddings change the K/V of equal tokens).  Hashed once per
        request: a head stalled for pages is not re-hashed every tick."""
        rid = request.request_id
        if rid not in self._digests:
            parts = []
            for key in sorted(request.extras or {}):
                t = torch.as_tensor(request.extras[key]).detach().cpu()
                raw = t.contiguous().reshape(-1).view(torch.uint8).numpy()
                parts.append(f"{key}:{tuple(t.shape)}:{t.dtype}:"
                             f"{hashlib.sha1(raw.tobytes()).hexdigest()[:16]}")
            self._digests[rid] = "|".join(parts)
        return self._digests[rid]

    def _flat_idx(self, lease: PageLease, n: int) -> torch.Tensor:
        """Host-built scatter map for the admission insert: position j ->
        pool row.  Prefix-shared positions and everything past the prompt
        go to the trash page (shared pages stay read-only, fresh pages
        stay zero past the prompt — the no-leak invariant)."""
        ps = self.page_size
        idx = np.full((self.max_len,), TRASH_PAGE, np.int64)
        for j in range(lease.hit_tokens, n):
            idx[j] = lease.pages[j // ps] * ps + j % ps
        return torch.from_numpy(idx).to(self.device, non_blocking=True)

    def _admit_ready(self, now: float) -> None:
        """Advance at most `chunk_budget` prefill chunks, then admit while
        slots AND pages allow.  Admission peeks at the FIFO head, reserves
        every page the request can ever touch, and pops it only then; a
        head that does not fit stalls the queue rather than be overtaken."""
        self._advance_prefill()
        while self._free:
            request = self._sched.peek_ready(now)
            if request is None:
                break
            sp = request.sampling
            n = len(request.tokens)
            rid = request.request_id
            chunked = (self.prefill_chunk is not None
                       and n > self.prefill_chunk)
            # the conditioning and the compute path join the prefix key:
            # only bit-identically produced prefixes share pages
            path = (f"chunk:{self.prefill_chunk}" if chunked else
                    f"bucket:{next(b for b in self.buckets if b >= n)}")
            digest = f"{self._conditioning_digest(request)}|{path}"
            lease = self._alloc.alloc(
                rid, n + sp.max_new_tokens - 1,
                prompt=tuple(request.tokens) if self.prefix_cache else None,
                digest=digest)
            if lease is None:
                self._paged_stalls += 1
                break
            self._sched.pop_ready(now)
            self._digests.pop(rid, None)
            ready_wall = self._sched.ready_wall(rid)
            slot_id = self._free.pop()
            self._leases[rid] = lease
            try:
                if chunked:
                    self._start_chunked(request, ready_wall, slot_id,
                                        lease, digest)
                else:
                    self._admit(request, ready_wall, slot_id,
                                lease=lease, digest=digest)
            except Exception:
                if self._slots[slot_id] is None:
                    self._free.append(slot_id)
                    self._sched.restore(request, ready_wall)
                    self._alloc.free(rid)
                    self._leases.pop(rid, None)
                raise

    def _admit(self, request: Request, ready_wall: float, slot_id: int,
               lease: PageLease | None = None, digest: str = "") -> None:
        """Whole-prompt admission: the slot engine's prefill and first-
        token draw (same bucket, same ops, same generator), then a paged
        insert in place of the slot insert."""
        sp = request.sampling
        extras = self._prefill_extras(request)
        t0 = time.perf_counter()
        logits, req_cache = self._prefill_request(request, extras)
        gen = self._request_generator(sp)
        first = sampling.sample_tokens(logits, [sp.temperature], [sp.top_k],
                                       [gen])
        first_tok = int(first[0])  # analysis: allow[JH101] the first token to the host, which emits it
        self._note_prefill(request.request_id, time.perf_counter() - t0)
        self._admitted += 1
        self._install(request, req_cache, extras, slot_id, lease, gen,
                      first_tok, ready_wall, digest)

    def _start_chunked(self, request: Request, ready_wall: float,
                       slot_id: int, lease: PageLease, digest: str) -> None:
        """First chunk of an interleaved prefill: the request takes its
        slot and pages now but joins decode only when the last chunk
        lands; meanwhile every tick decodes the active lanes.  The
        generator and the admission count are taken here, in admission
        order, as the slot engine takes them."""
        sp = request.sampling
        c = self.prefill_chunk
        prompt = np.asarray(request.tokens[:c], np.int64)[None]
        extras = self._prefill_extras(request)
        gen = self._request_generator(sp)
        self._admitted += 1
        t0 = time.perf_counter()
        _, workspace = api.prefill(
            self.exec_params,
            torch.from_numpy(prompt).to(self.device, non_blocking=True),
            self.cfg, self._spec, max_len=self.max_len, extras=extras,
            true_len=torch.tensor([c], dtype=torch.int32).to(
                self.device, non_blocking=True))
        _sync(self.device)
        self._note_prefill(request.request_id, time.perf_counter() - t0)
        self._chunks += 1
        self._slots[slot_id] = _PagedSlot(
            request, len(request.tokens), self._tick, ready_wall,
            self._admitted, speculating=self.draft_tier is not None,
            prefilling=True)
        self._jobs.append(_ChunkJob(request, slot_id, lease, digest, gen,
                                    extras, workspace, c))

    def _install(self, request: Request, req_cache: dict, extras: dict,
                 slot_id: int, lease: PageLease, gen: torch.Generator,
                 first_tok: int, ready_wall: float, digest: str,
                 slot: _PagedSlot | None = None) -> None:
        """Common tail of both admission paths: paged insert, lane state
        (the image embeddings of a cross-attention model among it), prefix
        registration, slot record, first emit."""
        sp = request.sampling
        n = len(request.tokens)
        self._arena.insert(req_cache, self._lane(slot_id),
                           self._flat_idx(lease, n))
        self._set_lane_extras(slot_id, extras)
        self._table_all[slot_id] = 0
        self._table_all[slot_id, :len(lease.pages)] = torch.tensor(
            lease.pages, dtype=torch.int64).to(self.device,
                                               non_blocking=True)
        self._temps[slot_id] = sp.temperature
        self._topks[slot_id] = sp.top_k
        self._gens[slot_id] = gen
        if self.prefix_cache:
            self._alloc.register_prefix(request.request_id,
                                        tuple(request.tokens), digest)
        if slot is None:
            slot = _PagedSlot(request, n, self._tick, ready_wall,
                              self._admitted,
                              speculating=self.draft_tier is not None)
            self._slots[slot_id] = slot
        slot.prefilling = False
        self._join(slot_id, first_tok)
        slot.first_wall = time.perf_counter()
        slot.first_tick = self._tick
        if slot.spec_counts is not None:
            slot.spec_counts["corrections"] += 1
            self._spec_totals["corrections"] += 1
        self._emit(slot_id, first_tok)

    # --- chunked-prefill advance ------------------------------------------

    def _advance_prefill(self) -> None:
        for _ in range(self.chunk_budget):
            if not self._jobs:
                return
            job = self._jobs[0]
            req = job.request
            over_budget = any(
                b is not None and self._tick - req.arrival + 1 >= b
                for b in (req.deadline_ticks, req.ttft_deadline_ticks))
            if over_budget:
                self._jobs.pop(0)
                self._evict(job.slot_id, "deadline")
                continue
            if self._advance_one(job):
                self._jobs.pop(0)

    def _advance_one(self, job: _ChunkJob) -> bool:
        """Run one chunk; True when the prefill finished (first token
        emitted, the request joins decode this tick)."""
        tokens = job.request.tokens
        n = len(tokens)
        take = min(self.prefill_chunk, n - job.pos)
        # the last chunk runs unpadded: eager PyTorch needs no static
        # shape, and masked steps would leave the workspace as it is
        piece = np.asarray(tokens[job.pos:job.pos + take], np.int64)[None]
        t0 = time.perf_counter()
        logits, job.workspace = api.chunk_step(
            self.exec_params, job.workspace,
            torch.from_numpy(piece).to(self.device, non_blocking=True),
            self.cfg, self._spec, job.extras)
        job.pos += take
        first_tok = None
        if job.pos >= n:
            sp = job.request.sampling
            first_tok = int(sampling.sample_tokens(  # analysis: allow[JH101] the first token to the host, which emits it
                logits[:, take - 1], [sp.temperature], [sp.top_k],
                [job.gen])[0])
        else:
            _sync(self.device)     # the first token's read waits otherwise
        dt = time.perf_counter() - t0
        self._note_prefill(job.request.request_id, dt)
        self._chunk_s += dt
        self._chunks += 1
        if first_tok is None:
            return False
        slot = self._slots[job.slot_id]
        self._install(job.request, job.workspace, job.extras, job.slot_id,
                      job.lease, job.gen, first_tok, slot.ready_wall,
                      job.digest, slot=slot)
        return True

    # --- eviction ---------------------------------------------------------

    def _evict(self, slot_id: int, reason: str) -> None:
        slot = self._slots[slot_id]
        rid = slot.request.request_id
        if slot.prefilling:
            # never emitted: TTFT = time waited (the budget it blew)
            slot.first_wall = time.perf_counter()
        super()._evict(slot_id, reason)
        if slot.spec_counts is not None:
            self.completions[-1].spec = SpecStats(**slot.spec_counts)
        self._alloc.free(rid)
        self._leases.pop(rid, None)
        # neutralize the freed lane: with a zero table row every write it
        # makes lands in the trash page, so reused pages are never
        # corrupted by a stale lane, and it draws from no generator
        if (lane := self._lane(slot_id)) is not None:
            self._arena.cache["length"][lane].fill_(0)
        self._table_all[slot_id] = 0
        self._temps[slot_id] = 0.0

    def _slot_of(self, request_id: str) -> int:
        slot_id = next((i for i, s in enumerate(self._slots)
                        if s is not None
                        and s.request.request_id == request_id), None)
        if slot_id is None:
            raise PagingError(
                f"request {request_id!r} is not resident "
                f"(never admitted, finished, or evicted)")
        return slot_id

    # --- copy-on-write ----------------------------------------------------

    def resolve_cow(self, request_id: str, index: int
                    ) -> tuple[int, int] | None:
        """Make block-table entry `index` of `request_id` writable:
        allocator bookkeeping, device page copy and table update.  The
        serving path never needs it (decode writes strictly past the last
        shareable page); it serves fork-style consumers and the tests."""
        op = self._alloc.cow(request_id, index)
        if op is None:
            return None
        src, dst = op
        self._arena.copy_pages([src], [dst])
        self._table_all[self._slot_of(request_id), index] = dst
        return op

    # --- decode -----------------------------------------------------------

    def _decode_lanes(self) -> list[int]:
        """Occupied slots that are not prefilling."""
        return [i for i in super()._decode_lanes()
                if not self._slots[i].prefilling]

    def _decode_step(self) -> None:
        """One decode step, or one draft + verify step when speculating."""
        if self.draft_tier is None:
            super()._decode_step()
        elif lanes := self._decode_lanes():
            self._quiet_idle_lanes(lanes)
            self._spec_step(lanes)

    def _decode(self) -> np.ndarray:
        """Non-speculative paged decode: gather the dense view of this
        rank's rows, run the slot engine's decode and sampling, commit
        each lane's one new K/V row to its page (idle lanes write the
        trash page) and the dense leaves whole, as the slot engine keeps
        them."""
        arena = self._arena
        cache = arena.cache
        old_len = cache["length"]
        view = arena.view(cache, self._table)
        with self._row_steps():
            logits, view = api.decode_step(self.exec_params, view,
                                           self._tok, self.cfg, self._spec,
                                           self._decode_extras())
        tok = sampling.sample_tokens(logits[:, -1], *self._lane_sampling())
        self._commit_rows(arena.flat_rows(self._table, old_len,
                                          self._all_lanes),
                          arena.rows_at(view, old_len))
        for key in self._dense:
            cache[key] = view[key]
        cache["length"] = view["length"]
        self._tok = tok[:, None]
        return self._all_rows(tok).cpu().numpy()  # analysis: allow[JH101] the step's tokens to the host, which emits and evicts

    def _commit_rows(self, flat: torch.Tensor, rows: dict) -> None:
        """Write K/V `rows` (`PagedArena.rows_at`'s layout) to the pool
        rows `flat`: every data rank's, all-gathered, where the rows are
        split (the pools are whole on every rank)."""
        if self.split_rows:
            flat = self._all_rows(flat)
            rows = {key: self._all_rows(r) for key, r in rows.items()}
        self._arena.put_rows(self._arena.cache, flat, rows)

    def _draft_tokens(self) -> torch.Tensor:
        """Draft `spec_k` greedy tokens per lane of this rank's rows on a
        throwaway view (its dense leaves copied, since the view shares
        the arena's) — nothing escapes but the proposals, so the draft
        tier never touches the arena.  Returns (rows, spec_k)."""
        view = self._own_dense(
            self._arena.view(self._arena.cache, self._table))
        tok, out = self._tok, []
        for _ in range(self.spec_k):
            with self._row_steps():
                logits, view = api.decode_step(
                    self._draft_exec, view, tok, self.cfg,
                    self._draft_spec, self._decode_extras())
            tok = torch.argmax(logits[:, -1].float(), dim=-1)[:, None]
            out.append(tok)
        return torch.cat(out, dim=1)

    def _verify(self, draft: torch.Tensor, k_row: np.ndarray
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Verify the drafts in one loop of the serving tier's own
        decode_step.  Per lane: emit the longest agreeing prefix plus one
        correction (greedy), or one token drawn once from the lane's
        generator (sampled); commit only the K/V rows of emitted positions
        (the rest go to the trash page); the length advances by the
        emitted count.  Lanes past their `k_row` are frozen: their length
        and dense state stay and their K/V rows are never committed.  Each
        live row is taken right after the step that writes it, since a
        frozen lane at max_len rewrites (clamped) its last row.  Each step
        runs on copies of the dense leaves and keeps the lane-selected
        result as a snapshot; each lane's dense state becomes its snapshot
        at its last emitted position (step m - 1; step 0, the frozen
        state, for a lane that emits nothing).  Runs on this rank's rows
        (`draft` and `k_row` are theirs).  Returns (emitted (rows, k),
        emitted count m, accepted count a)."""
        arena, k, cap = self._arena, self.spec_k, self._rows
        temps, topks, gens = self._lane_sampling()
        cache = arena.cache
        old_len = cache["length"]
        kr = torch.from_numpy(k_row).to(self.device, non_blocking=True)
        view = arena.view(cache, self._table)
        tok, lgs, rows, snaps = self._tok, [], [], []
        for i in range(k):
            pos = torch.clamp(old_len + i, max=self.max_len - 1).long()
            with self._row_steps():
                logits, new = api.decode_step(
                    self.exec_params, self._own_dense(view), tok, self.cfg,
                    self._spec, self._decode_extras())
            live = kr > i
            new["length"] = torch.where(live, new["length"], view["length"])
            for key in self._dense:
                new[key] = _sel(live, new[key], view[key],
                                arena.slot_axes[key])
            view = new
            snaps.append({key: view[key] for key in self._dense})
            lgs.append(logits[:, -1])
            rows.append(arena.rows_at(view, pos))
            tok = torch.where(live[:, None], draft[:, i:i + 1], tok)
        e = torch.argmax(torch.stack(lgs, dim=1).float(), dim=-1)
        corr0 = sampling.sample_tokens(lgs[0], temps, topks, gens)
        # the verdicts, the drafts and the sampled corrections in one read
        host = torch.cat([e, draft, corr0[:, None]], 1).cpu().numpy()  # analysis: allow[JH101] the step's verdicts to the host, which emits and evicts
        e, d, corr0 = host[:, :k], host[:, k:2 * k], host[:, 2 * k]
        greedy = np.array([t <= 0.0 for t in temps])
        agree = np.cumprod(e == d, axis=1)
        a = np.minimum(np.where(greedy, agree.sum(axis=1), 0), k_row)
        m = np.where(a >= k_row, k_row, a + 1)        # 0 when k_row == 0
        host_lanes = np.arange(cap)
        corr = np.where(greedy, e[host_lanes, np.minimum(a, k - 1)], corr0)
        emitted = np.where(np.arange(k)[None, :] < a[:, None], d,
                           corr[:, None])
        mt = torch.from_numpy(m).to(self.device, non_blocking=True)
        flat = torch.cat([arena.flat_rows(self._table, old_len + i, mt > i)
                          for i in range(k)])
        self._commit_rows(flat, {key: torch.cat([rw[key] for rw in rows])
                                 for key in arena.paged})
        last = torch.from_numpy(np.maximum(m - 1, 0)).to(self.device,
                                                         non_blocking=True)
        for key in self._dense:
            cache[key] = _pick_snap([sn[key] for sn in snaps], last,
                                    arena.slot_axes[key])
        cache["length"] = old_len + mt.to(old_len.dtype)
        self._tok = torch.from_numpy(
            emitted[host_lanes, np.maximum(m - 1, 0)][:, None]).to(
                self.device, non_blocking=True)
        return emitted, m, a

    def _own_dense(self, view: dict) -> dict:
        """`view` with copies of its dense leaves, which a decode step may
        then advance (or write in place) without touching the originals."""
        return dict(view, **{key: view[key].clone() for key in self._dense})

    def _spec_step(self, decoding: list[int]) -> None:
        """Draft + verify one speculative step: greedy lanes emit up to
        `spec_k` accepted drafts + 1 correction, sampled lanes emit one
        token, idle and prefilling lanes are frozen (k_row = 0)."""
        kr = np.zeros((self.capacity,), np.int64)
        for i in decoding:
            slot = self._slots[i]
            sp = slot.request.sampling
            if sp.temperature <= 0.0:
                kr[i] = min(self.spec_k,
                            sp.max_new_tokens - len(slot.tokens))
            else:
                kr[i] = 1
        mark = self._mark()
        hi = self._lo + self._rows
        emitted, mh, ah = self._verify(self._draft_tokens(), kr[self._lo:hi])
        if self.split_rows:
            # every rank's lanes: (emitted | m | a) per lane, one gather
            packed = np.concatenate([emitted, mh[:, None], ah[:, None]], 1)
            gathered = self._all_rows(torch.from_numpy(packed).to(
                self.device, non_blocking=True))
            packed = gathered.cpu().numpy()  # analysis: allow[JH101] every data rank's verdicts to the host, which emits
            emitted, mh, ah = packed[:, :-2], packed[:, -2], packed[:, -1]
        self._spec_steps += 1
        # every decoding lane is charged alike, sampled or greedy
        self._note_decode(decoding, mark)
        for i in decoding:
            slot = self._slots[i]
            if slot.request.sampling.temperature <= 0.0:
                slot.spec_counts["proposed"] += int(kr[i])
                self._spec_totals["proposed"] += int(kr[i])
            for j in range(int(mh[i])):
                field = "accepted" if j < int(ah[i]) else "corrections"
                # count BEFORE emitting: _emit may evict and freeze the
                # Completion's SpecStats this very token
                slot.spec_counts[field] += 1
                self._spec_totals[field] += 1
                self._emit(i, int(emitted[i, j]))
                if self._slots[i] is None:
                    break

    # --- introspection ----------------------------------------------------

    def debug_kv_rows(self, request_id: str) -> dict:
        """Test/debug surface: the request's dense gathered KV rows per
        paged leaf ((max_len, ...) each), its length, and how many
        positions its lease reserves — what the no-leak check needs.
        Where the rows are split every rank calls it (it all-gathers the
        lengths)."""
        slot_id = self._slot_of(request_id)
        view = self._arena.view(self._arena.cache,
                                self._table_all[slot_id:slot_id + 1])
        out = {}
        for key, axis in self._arena.paged.items():
            rows = view[key].movedim((axis, axis + 1), (0, 1))
            out[key] = rows[0].cpu().numpy()
        lease = self._leases[request_id]
        lengths = self._all_rows(self._arena.cache["length"])
        return {"rows": out,
                "length": int(lengths[slot_id]),
                "reserved": len(lease.pages) * self.page_size,
                "shared_tokens": lease.hit_tokens}

    def stats(self) -> dict:
        out = super().stats()
        out["paged"] = {
            **self._alloc.stats(),
            "admission_stalls": self._paged_stalls,
            "max_pages_per_request": self._arena.max_pages,
            "paged_leaves": sorted(self._arena.paged),
            "chunked": {"enabled": self.prefill_chunk is not None,
                        "chunk": self.prefill_chunk,
                        "budget": self.chunk_budget,
                        "chunks": self._chunks,
                        "chunk_step_s": self._chunk_s,
                        "inflight": len(self._jobs)},
        }
        if self.draft_tier is not None:
            tot = self._spec_totals
            out["spec"] = {
                "draft_tier": self.draft_tier, "k": self.spec_k,
                "steps": self._spec_steps, **tot,
                "acceptance_rate": (tot["accepted"] / tot["proposed"]
                                    if tot["proposed"] else 0.0)}
        return out


def _sel(live: torch.Tensor, new: torch.Tensor, old: torch.Tensor,
         axis: int) -> torch.Tensor:
    """Per-lane select along the slot `axis`: `new` where the lane is
    live, `old` where it is frozen."""
    shape = [1] * new.ndim
    shape[axis] = live.shape[0]
    return torch.where(live.reshape(shape), new, old)


def _pick_snap(snaps: list, idx: torch.Tensor, axis: int) -> torch.Tensor:
    """Per-lane snapshot pick: lane j takes step `idx[j]`'s leaf among the
    per-step `snaps` (each with the lanes along `axis`)."""
    moved = torch.stack(snaps).movedim(axis + 1, 1)          # (k, cap, ...)
    lanes = torch.arange(idx.shape[0], device=idx.device)
    return moved[idx, lanes].movedim(0, axis).contiguous()
