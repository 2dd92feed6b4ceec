"""Continuous-batching inference engine over `models/api.py`.

Requests are admitted from a FIFO queue (by arrival tick, then submission
order) into free slots of a fixed-capacity decode arena — prefill, then
join — every decode step advances all occupied slots at their own per-slot
lengths, and finished requests (max tokens / EOS / deadline) are evicted so
their slots can be reused mid-flight.

Approximate serving composes transparently: the engine resolves
`cfg.mult` / `cfg.kernel_policy` through `api.make_spec` and serves from a
persistent weight-plane cache (`api.prepare_params`), so each GEMM weight
is quantized once at construction.  `tiers=` names an ordered ladder of
multipliers (index 0 serves by default); `set_tier` switches prefill and
decode to another tier's artifacts without touching the KV arena, and
every emitted token is attributed to the tier that produced it.

Request lifecycle: per-request TTFT/total deadlines in ticks, with
load-shedding (`finish_reason="shed"`) and mid-decode deadline eviction
(`"deadline"`); a crash inside admission re-queues the request before
propagating.

Conditioning: a request of the `encdec` family carries its frames, one of
a cross-attention `lm` its image embeddings, in `Request.extras`
(`api.extras_shapes` names the keys and shapes).  Prefill consumes them
(zeros where a request carries none, as in the reference); image
embeddings are also kept per slot and passed to every decode step.

Metering (`meter=`, a `fleet.meter.EnergyMeter`): each prefill and decode
step is timed on the host clock after the step's device sync, and the
meter turns those seconds into per-request Joules and CO2eq
(`Completion.carbon`, `stats()["carbon"]`).

Tensor parallelism (`mesh=`, a `launch.mesh.Mesh`, or `target=`, which
builds its mesh: one die == one TP shard): every rank of the mesh runs
this same engine loop (SPMD), one process per rank.  Each rank keeps its
column block of every approximate GEMM weight (`api.prepare_params`) and
its heads of the K/V cache (`api.init_cache`), and every model call runs
under the mesh's rules (`sharding.ctx`): the GEMMs run column-parallel and
all-gather what a later op needs whole.  Admission, eviction and
sampling read only ticks, tokens and each request's seeded generator,
all equal on every rank because the logits are; host clocks feed only
`stats()`.

Data parallelism: where the mesh's dp axes divide `capacity`
(`sharding.rules.batch_pspec`), data rank d holds slots [d * c / D,
(d + 1) * c / D), as the reference's `NamedSharding` lays dim 0 out:
its arena (`api.init_cache(split_rows=True)`), lengths, last tokens,
idle mask and image embeddings hold those rows alone, and its decode
step runs on them.  Prefill (batch 1, which the rule leaves whole) runs
on every rank, and every rank draws the first token from the request's
generator, so admission, eviction and the scheduler stay the same on
every rank with no exchange; only the slot's owner inserts the row.
The norms and decode attention run a rank's rows among zero rows of the
whole capacity (`sharding.ctx.whole_rows`, `models.common.on_whole_rows`),
so their kernels see one device's shapes and round as one device's do.
After each decode step the ranks all-gather their sampled tokens over
the dp axes (one int64 vector), and every rank's host loop emits every
slot's token.  Rows stay whole (every rank computes every row) where the
capacity does not divide, and for an MoE config: capacity couples a
call's rows, so a rank's routing of its own rows would not be the
whole batch's.
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.serving import sampling
from repro_torch.serving.arena import SlotArena
from repro_torch.serving.scheduler import Scheduler
from repro_torch.serving.types import Completion, Request


def prefill_extras(cfg: ModelConfig, extras: dict | None,
                   device) -> dict:
    """One request's conditioning as prefill takes it: each array the
    config consumes, reshaped to (1, ...) on `device` (f64 to f32, as the
    reference's `jnp.asarray` gives it); zeros of the model's dtype where
    the request carries none."""
    given = extras or {}
    out = {}
    for key, shape in api.extras_shapes(cfg).items():
        arr = given.get(key)
        if arr is None:
            out[key] = torch.zeros((1, *shape), device=device,
                                   dtype=getattr(torch, cfg.dtype))
            continue
        t = torch.as_tensor(arr)
        if t.dtype == torch.float64:
            t = t.float()
        out[key] = t.to(device).reshape(1, *shape)
    return out


class _Slot:
    """Host-side record of one occupied arena slot."""

    def __init__(self, request: Request, prompt_len: int, admitted_tick: int,
                 ready_wall: float, admit_seq: int):
        self.request = request
        self.prompt_len = prompt_len
        self.tokens: list[int] = []
        self.admitted_tick = admitted_tick
        self.ready_wall = ready_wall
        self.first_wall = 0.0
        #: engine tick at which the first token was emitted (chunked
        #: prefill emits it later than admitted_tick)
        self.first_tick = admitted_tick
        self.admit_seq = admit_seq            # FIFO drain order
        self.tier_tokens: dict[str, int] = {}


class Engine:
    """Slot-based continuous-batching engine.

    Args:
      cfg: model config (the `lm` family, MoE included, `ssm`, `hybrid`
        or `encdec`).  An MoE layer routes every row of a decode call
        under one expert capacity, so an idle lane's row takes capacity
        as a live one does: for an MoE config each idle lane is reset to
        token 0 at length 0 before every decode step
        (`_quiet_idle_lanes`), which makes its row the same in every
        engine whatever the lane held before.
      params: model params; initialized from `seed` when None.
      capacity: decode-arena slots (max concurrent requests).
      max_len: arena sequence horizon; prompt_len + max_new_tokens - 1
        must fit.
      prefill_buckets: prompt pad lengths (default (max_len,)).
      seed: params init and per-request sampling streams.
      on_token: streaming callback `f(request_id, token_id)`.
      tiers: ordered multiplier-tier ladder (names resolvable by
        `api.make_spec`); None keeps one tier named by `cfg.mult`.
      device: where the engine runs; None means the CUDA device, and
        raises when there is none.
      meter: optional `fleet.meter.EnergyMeter`, charged with the measured
        seconds of every prefill and decode step; None serves unmetered.
      target: optional `core.target.HardwareTarget`, kept for the fleet's
        power model; when `mesh` is None it builds the mesh
        (`HardwareTarget.make_mesh`: one die == one TP shard).
      mesh: optional `launch.mesh.Mesh` to serve tensor-parallel over,
        every rank running this engine (module docstring).  A mesh over
        more ranks than the process group has raises `ValueError` where
        it is made.
    """

    #: Host syncs of each step on one device, which a CUDA graph over the
    #: step must first remove (ROADMAP Queue 2): a decode step reads its
    #: tokens (`_decode`), an admission its first token (`_admit`).
    #: `repro_torch.analysis.retrace` holds a card run to them.
    HOST_SYNCS = {"decode": 1, "prefill": 1}

    def __init__(self, cfg: ModelConfig, params: Any | None = None, *,
                 capacity: int = 4, max_len: int = 256,
                 prefill_buckets: tuple[int, ...] | None = None,
                 seed: int = 0,
                 on_token: Callable[[str, int], None] | None = None,
                 tiers: tuple[str, ...] | None = None,
                 device: str | torch.device | None = None,
                 meter=None, target=None, mesh=None):
        if mesh is None and target is not None:
            mesh = target.make_mesh()
        self.mesh = mesh
        self.device = resolve_device(device)
        self.meter, self.target = meter, target
        self.cfg, self.seed = cfg, seed
        self.capacity, self.max_len = capacity, max_len
        self.buckets = tuple(sorted(prefill_buckets or (max_len,)))
        self._lo, self._rows, self._row_spec = self._row_block()
        self.on_token = on_token
        self.tiers = tuple(tiers) if tiers else (cfg.mult or "exact",)
        if len(set(self.tiers)) != len(self.tiers):
            raise ValueError(f"duplicate tier names in {self.tiers}")
        self.params = params if params is not None else api.init_params(
            cfg, seed, self.device)

        with self._rules():
            self._build_state()

        # Per-tier serving artifacts: the weight-plane cache is built once
        # per (weight, multiplier); switching tiers is a pointer swap.
        self._tier_specs: dict[str, Any] = {}
        self._tier_exec: dict[str, Any] = {}
        for name in self.tiers:
            spec = api.make_spec(cfg, mult=name, device=self.device)
            self._tier_specs[name] = spec
            self._tier_exec[name] = api.prepare_params(self.params, cfg,
                                                       spec, mesh=mesh)
        self._tier = self.tiers[0]
        self._tier_tokens: dict[str, int] = {t: 0 for t in self.tiers}
        self._tier_switches: list[dict] = []
        self._activate(self._tier)

        self._sched = Scheduler()
        self._ids: set[str] = set()
        self._slots: list[_Slot | None] = [None] * capacity
        self._free = list(range(capacity - 1, -1, -1))
        self._tick = 0
        self._decode_steps = 0
        self._admitted = 0
        self._prefill_s = 0.0
        self._decode_s = 0.0
        self._decode_gathers = 0
        self._decode_collective_s = 0.0
        self._decode_data_gathers = 0
        self._decode_data_s = 0.0
        # the mesh's collectives before this engine ran any
        self._mark0 = self._mark()
        self._queue_wait_ticks = 0.0
        self._evictions = {"eos": 0, "length": 0}
        self.completions: list[Completion] = []

    def _rules(self):
        """The mesh's sharding context, which every model call of the
        engine runs under (nothing without a mesh)."""
        if self.mesh is None:
            return contextlib.nullcontext()
        from repro_torch.sharding import ctx, rules
        return ctx.use_rules(self.mesh, rules.logical_rules(self.mesh))

    def _mark(self) -> tuple[float, int, float, int, float]:
        """(host time, the mesh's all-gathers and their seconds on the
        model axis, then on the dp axes, so far): a step's accounting
        reads its deltas from this mark."""
        if self.mesh is None:
            return time.perf_counter(), 0, 0.0, 0, 0.0
        from repro_torch.sharding import rules
        return (time.perf_counter(), *self.mesh.gathers_on("model"),
                *self.mesh.gathers_on(rules.dp_axes(self.mesh)))

    def _row_block(self) -> tuple[int, int, tuple | None]:
        """(first slot, slot count, spec of the slot dim) of this rank's
        rows (module docstring): its block of the slots over the dp axes
        where they divide the capacity, else every slot, as for an MoE
        config."""
        if self.mesh is None or self.cfg.is_moe:
            return 0, self.capacity, None
        from repro_torch.sharding import rules
        spec = rules.batch_pspec("slots", (self.capacity,), self.mesh)
        rows = self.mesh.block(torch.arange(self.capacity), spec,
                               copy=False)
        return int(rows[0]), rows.numel(), spec

    @property
    def split_rows(self) -> bool:
        """Whether this rank holds a block of the slots, not all."""
        return self._rows < self.capacity

    def _lane(self, slot_id: int) -> int | None:
        """`slot_id`'s row among this rank's rows; None where another
        data rank holds it."""
        lane = slot_id - self._lo
        return lane if 0 <= lane < self._rows else None

    def _row_steps(self):
        """The context of a decode step on this rank's rows: where they
        are a block of the slots, the norms and decode attention run them
        among zero rows of the whole capacity (`sharding.ctx.whole_rows`)."""
        if not self.split_rows:
            return contextlib.nullcontext()
        from repro_torch.sharding import ctx
        return ctx.whole_rows(self._lo, self.capacity)

    def _all_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's rows of `x` (this rank's rows first on dim 0),
        all-gathered over the dp axes in slot order; `x` itself where
        the rows are whole."""
        if not self.split_rows:
            return x
        return self.mesh.gather_leaf(x, self._row_spec)

    def _lane_sampling(self) -> tuple[list, list, list]:
        """Temperatures, top-ks and generators of this rank's rows."""
        hi = self._lo + self._rows
        return (self._temps[self._lo:hi], self._topks[self._lo:hi],
                self._gens[self._lo:hi])

    def _build_state(self) -> None:
        """The decode arena and the per-lane sampling state."""
        self._arena = SlotArena(self.cfg, self.capacity, self.max_len,
                                self.device, split_rows=self.split_rows)
        self._init_lanes()

    def _init_lanes(self) -> None:
        """Per-lane state: last token of this rank's rows, temperature,
        top-k and generator of every slot (host lists), and, for a
        cross-attention model, the rows' image embeddings (rows,
        n_img_tokens, d) in the model's dtype."""
        capacity, rows, cfg = self.capacity, self._rows, self.cfg
        self._tok = torch.zeros((rows, 1), dtype=torch.int64,
                                device=self.device)
        # lanes that emit no token at the next decode step (free, or
        # prefilling in the paged engine); set as a lane joins decode and
        # leaves it, read by `_quiet_idle_lanes`
        self._idle = torch.ones((rows,), dtype=torch.bool,
                                device=self.device)
        self._temps = [0.0] * capacity
        self._topks = [0] * capacity
        self._gens: list[torch.Generator | None] = [None] * capacity
        self._img = None
        if cfg.cross_every:
            self._img = torch.zeros(
                (rows, cfg.n_img_tokens, cfg.d_model),
                dtype=getattr(torch, cfg.dtype), device=self.device)

    def _decode_extras(self) -> dict:
        """The per-slot conditioning every decode step takes."""
        return {} if self._img is None else {"img_embeds": self._img}

    def _set_lane_extras(self, slot_id: int, extras: dict) -> None:
        """Keep an admitted request's image embeddings in its slot's row
        (on the rank that holds it)."""
        lane = self._lane(slot_id)
        if self._img is not None and lane is not None:
            self._img[lane] = extras["img_embeds"][0].to(self._img.dtype)

    def _join(self, slot_id: int, first_tok: int) -> None:
        """The slot's row joins decode with its first token."""
        lane = self._lane(slot_id)
        if lane is not None:
            # fill_ takes the value as a kernel argument: no host copy
            self._tok[lane, 0].fill_(first_tok)
            self._idle[lane].fill_(False)

    # --- degradation tiers ------------------------------------------------

    @property
    def tier(self) -> str:
        """Name of the multiplier tier currently serving."""
        return self._tier

    @property
    def tier_index(self) -> int:
        return self.tiers.index(self._tier)

    def _activate(self, name: str) -> None:
        self._spec = self._tier_specs[name]
        self.exec_params = self._tier_exec[name]

    def set_tier(self, name: str) -> None:
        """Switch the serving tier (prefill AND decode).  In-flight
        requests keep their KV; tokens emitted after the switch are
        attributed to the new tier."""
        if name not in self._tier_specs:
            raise ValueError(
                f"unknown tier {name!r}; engine tiers: {self.tiers}")
        if name == self._tier:
            return
        self._tier_switches.append(
            {"tick": self._tick, "from": self._tier, "to": name})
        self._tier = name
        self._activate(name)

    # --- submission -------------------------------------------------------

    def submit(self, request: Request) -> None:
        """Queue a request for admission at its arrival tick."""
        n = len(request.tokens)
        sp = request.sampling
        if request.request_id in self._ids:
            raise ValueError(
                f"duplicate request_id {request.request_id!r}")
        if n < 1:
            raise ValueError(f"{request.request_id}: empty prompt")
        if n > self.buckets[-1]:
            raise ValueError(
                f"{request.request_id}: prompt len {n} exceeds largest "
                f"prefill bucket {self.buckets[-1]}")
        if sp.max_new_tokens < 1:
            raise ValueError(f"{request.request_id}: max_new_tokens < 1")
        if n + sp.max_new_tokens - 1 > self.max_len:
            raise ValueError(
                f"{request.request_id}: prompt {n} + {sp.max_new_tokens} "
                f"new tokens exceeds arena max_len {self.max_len}")
        for field in ("ttft_deadline_ticks", "deadline_ticks"):
            v = getattr(request, field)
            if v is not None and v < 1:
                raise ValueError(f"{request.request_id}: {field} must be "
                                 f">= 1 tick (got {v})")
        self._check_extras(request)
        self._ids.add(request.request_id)
        self._sched.submit(request)

    def _check_extras(self, request: Request) -> None:
        """Extras only for a config that consumes them, each under one of
        its keys and reshapable to that key's shape."""
        if not request.extras:
            return
        rid, want = request.request_id, api.extras_shapes(self.cfg)
        if not want:
            raise ValueError(f"{rid}: extras (frames / image embeddings) "
                             f"given to {self.cfg.name}, which takes none")
        for key, arr in request.extras.items():
            if key not in want:
                raise ValueError(f"{rid}: extras key {key!r}; "
                                 f"{self.cfg.name} takes {sorted(want)}")
            size = arr.numel() if torch.is_tensor(arr) else np.size(arr)
            if size != math.prod(want[key]):
                raise ValueError(
                    f"{rid}: extras[{key!r}] of {size} values does not "
                    f"reshape to {want[key]}")

    # --- admission (prefill-then-join) -----------------------------------

    def _prefill_extras(self, request: Request) -> dict:
        return prefill_extras(self.cfg, request.extras, self.device)

    def _request_generator(self, sp) -> torch.Generator:
        seed = sp.seed if sp.seed is not None else \
            self.seed * 1_000_003 + 1 + self._admitted
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def _prefill_request(self, request: Request, extras: dict) -> tuple:
        """The whole prompt right-padded to its bucket, prefilled with the
        request's `extras` (`_prefill_extras`): (logits of its last token
        (1, vocab), its 1-row cache at max_len)."""
        n = len(request.tokens)
        bucket = next(b for b in self.buckets if b >= n)
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :n] = np.asarray(request.tokens, np.int64)
        return api.prefill(
            self.exec_params,
            torch.from_numpy(padded).to(self.device, non_blocking=True),
            self.cfg, self._spec, max_len=self.max_len, extras=extras,
            true_len=torch.tensor([n], dtype=torch.int32).to(
                self.device, non_blocking=True))

    def _admit(self, request: Request, ready_wall: float,
               slot_id: int) -> None:
        sp = request.sampling
        n = len(request.tokens)
        extras = self._prefill_extras(request)
        t0 = time.perf_counter()
        logits, req_cache = self._prefill_request(request, extras)
        gen = self._request_generator(sp)
        first = sampling.sample_tokens(logits, [sp.temperature], [sp.top_k],
                                       [gen])
        first_tok = int(first[0])  # analysis: allow[JH101] the first token to the host, which emits it
        self._note_prefill(request.request_id, time.perf_counter() - t0)
        self._admitted += 1

        if (lane := self._lane(slot_id)) is not None:
            self._arena.insert(req_cache, lane)
        self._set_lane_extras(slot_id, extras)
        self._temps[slot_id] = sp.temperature
        self._topks[slot_id] = sp.top_k
        self._gens[slot_id] = gen

        slot = _Slot(request, n, self._tick, ready_wall, self._admitted)
        slot.first_wall = time.perf_counter()
        self._slots[slot_id] = slot
        self._join(slot_id, first_tok)
        self._emit(slot_id, first_tok)

    def _note_prefill(self, request_id: str, dt: float) -> None:
        """Book a synced prefill (or prefill chunk) of `dt` seconds."""
        self._prefill_s += dt
        if self.meter is not None:
            self.meter.on_prefill(request_id, dt)

    # --- token accounting / eviction -------------------------------------

    def _emit(self, slot_id: int, token: int) -> None:
        slot = self._slots[slot_id]
        slot.tokens.append(token)
        slot.tier_tokens[self._tier] = \
            slot.tier_tokens.get(self._tier, 0) + 1
        self._tier_tokens[self._tier] += 1
        if self.on_token is not None:
            self.on_token(slot.request.request_id, token)
        sp = slot.request.sampling
        req = slot.request
        if sp.eos_id >= 0 and token == sp.eos_id:
            self._evict(slot_id, "eos")
        elif len(slot.tokens) >= sp.max_new_tokens:
            self._evict(slot_id, "length")
        elif req.deadline_ticks is not None and \
                self._tick - req.arrival + 1 >= req.deadline_ticks:
            self._evict(slot_id, "deadline")

    def _evict(self, slot_id: int, reason: str) -> None:
        slot = self._slots[slot_id]
        now = time.perf_counter()
        self._evictions[reason] = self._evictions.get(reason, 0) + 1
        self._queue_wait_ticks += max(
            0.0, slot.admitted_tick - slot.request.arrival)
        self.completions.append(Completion(
            request_id=slot.request.request_id,
            prompt_len=slot.prompt_len,
            tokens=slot.tokens,
            finish_reason=reason,
            arrival=slot.request.arrival,
            admitted_tick=slot.admitted_tick,
            finished_tick=self._tick,
            ttft_s=slot.first_wall - slot.ready_wall,
            ttft_ticks=slot.first_tick - slot.request.arrival + 1.0,
            latency_s=now - slot.ready_wall,
            carbon=self._finalize(slot.request.request_id,
                                  len(slot.tokens)),
            attempt=slot.request.attempt,
            tier_tokens=dict(slot.tier_tokens)))
        self._slots[slot_id] = None
        self._gens[slot_id] = None
        if (lane := self._lane(slot_id)) is not None:
            self._idle[lane].fill_(True)
        self._free.append(slot_id)

    def _shed(self, request: Request) -> None:
        """Complete a never-admitted request whose deadline is already
        unmeetable (load shedding at admission)."""
        self._evictions["shed"] = self._evictions.get("shed", 0) + 1
        self._sched._ready_wall.pop(request.request_id, None)
        self.completions.append(Completion(
            request_id=request.request_id,
            prompt_len=len(request.tokens),
            tokens=[],
            finish_reason="shed",
            arrival=request.arrival,
            admitted_tick=-1,
            finished_tick=self._tick,
            ttft_s=0.0,
            latency_s=0.0,
            carbon=self._finalize(request.request_id, 0),
            attempt=request.attempt,
            tier_tokens={}))

    def _finalize(self, request_id: str, tokens: int):
        """Close the request's meter account (None when unmetered)."""
        if self.meter is None:
            return None
        return self.meter.finalize(request_id, tokens)

    # --- the serving loop -------------------------------------------------

    @property
    def tick(self) -> int:
        """Current virtual-clock tick (one decode step per tick)."""
        return self._tick

    @property
    def n_active(self) -> int:
        return self.capacity - len(self._free)

    @property
    def n_queued(self) -> int:
        return len(self._sched)

    def pending_requests(self) -> list[Request]:
        """Every submitted-but-unfinished request in FIFO order: slot
        occupants by admission order, then the waiting queue."""
        active = sorted((s for s in self._slots if s is not None),
                        key=lambda s: s.admit_seq)
        out = [s.request for s in active]
        out.extend(self._sched.pending())
        return out

    def active_request_ids(self) -> set[str]:
        return {s.request.request_id for s in self._slots if s is not None}

    def _decode(self) -> np.ndarray:
        """Decode and sample this rank's rows; every slot's token."""
        with self._row_steps():
            logits, cache = api.decode_step(
                self.exec_params, self._arena.cache, self._tok, self.cfg,
                self._spec, self._decode_extras())
        self._arena.cache = cache
        tok = sampling.sample_tokens(logits[:, -1], *self._lane_sampling())
        self._tok = tok[:, None]
        return self._all_rows(tok).cpu().numpy()  # analysis: allow[JH101] the step's tokens to the host, which emits and evicts

    def step(self) -> None:
        """One engine tick: shed dead-on-arrival requests, admit due
        requests into free slots, then run one decode step across the
        whole arena."""
        with self._rules():
            self._step()

    def _step(self) -> None:
        now = self._tick
        self._sched.note_ready(now, time.perf_counter())
        for request in self._sched.pop_expired(now):
            self._shed(request)
        self._admit_ready(now)
        if self.n_active:
            self._decode_step()
        self._tick += 1

    def _admit_ready(self, now: float) -> None:
        """Admit due requests, FIFO, while slots are free."""
        while self._free:
            request = self._sched.pop_ready(now)
            if request is None:
                break
            ready_wall = self._sched.ready_wall(request.request_id)
            slot_id = self._free.pop()
            try:
                self._admit(request, ready_wall, slot_id)
            except Exception:
                # keep the request drainable: back on the queue, slot freed
                if self._slots[slot_id] is None:
                    self._free.append(slot_id)
                    self._sched.restore(request, ready_wall)
                raise

    def _decode_lanes(self) -> list[int]:
        """The slots that emit this step: every occupied one."""
        return [i for i, s in enumerate(self._slots) if s is not None]

    def _quiet_idle_lanes(self, lanes: list[int]) -> None:
        """MoE configs only: every lane not in `lanes` (the idle mask
        `_idle`, kept on the device) takes token 0 at length 0, so its
        attention sees only the K/V row it writes this step and its row
        is a function of the model alone — the same in the slot and the
        paged engine, whose idle lanes otherwise hold different stale
        state (a freed slot's K/V here, the trash page there).  In a model
        whose rows do not share a capacity an idle row changes no live
        one, and nothing is reset.  An MoE config keeps its rows whole
        on every rank (`_row_block`), so lanes are slots here."""
        if not self.cfg.is_moe or len(lanes) == self.capacity:
            return
        self._tok = self._tok.masked_fill(self._idle[:, None], 0)
        cache = self._arena.cache
        cache["length"] = cache["length"].masked_fill(self._idle, 0)

    def _decode_step(self) -> None:
        """One decode step of the whole arena; the decode lanes emit."""
        lanes = self._decode_lanes()
        if not lanes:
            return
        self._quiet_idle_lanes(lanes)
        mark = self._mark()
        tok_host = self._decode()
        self._note_decode(lanes, mark)
        for slot_id in lanes:
            if self._slots[slot_id] is not None:
                self._emit(slot_id, int(tok_host[slot_id]))

    def _note_decode(self, lanes: list[int], mark: tuple) -> None:
        """Book a synced decode step over `lanes` that started at `mark`
        (`_mark`).  The meter is charged BEFORE the lanes emit: a request
        evicted at this step carries its share of the step's energy."""
        t0, gathers, coll_s, data_gathers, data_s = self._mark()
        dt = t0 - mark[0]
        self._decode_steps += 1
        self._decode_s += dt
        self._decode_gathers += gathers - mark[1]
        self._decode_collective_s += coll_s - mark[2]
        self._decode_data_gathers += data_gathers - mark[3]
        self._decode_data_s += data_s - mark[4]
        if self.meter is not None:
            self.meter.on_decode(
                dt, [self._slots[i].request.request_id for i in lanes],
                self.capacity)

    def run_until_complete(self) -> list[Completion]:
        """Drive step() until the queue and the arena are both empty;
        idle ticks fast-forward to the next arrival."""
        while self.n_queued or self.n_active:
            if not self.n_active:
                nxt = self._sched.next_arrival()
                if nxt is not None and nxt > self._tick:
                    self._tick = int(math.ceil(nxt))
            self.step()
        return self.completions

    def stats(self) -> dict:
        done = len(self.completions)
        out = {"ticks": self._tick, "decode_steps": self._decode_steps,
               "admitted": self._admitted,
               "completed": done,
               "prefill_s": self._prefill_s, "decode_s": self._decode_s,
               "queue_wait_ticks_total": self._queue_wait_ticks,
               "queue_wait_ticks_mean":
                   self._queue_wait_ticks / done if done else 0.0,
               "evictions": dict(self._evictions),
               "device": str(self.device),
               "tiers": {"active": self._tier,
                         "ladder": list(self.tiers),
                         "tokens": dict(self._tier_tokens),
                         "switches": list(self._tier_switches)}}
        if self.meter is not None:
            out["carbon"] = self.meter.summary()
        if self.mesh is not None:
            out["mesh"] = {"data": self.mesh.axis_size("data"),
                           "model": self.mesh.axis_size("model")}
        if self.mesh is not None and self.mesh.size > 1:
            steps = self._decode_steps
            _, gathers, coll_s, data_gathers, data_s = self._mark()
            # the model axis's all-gathers, then the dp axes' (each rank's
            # sampled tokens; the paged engine's written K/V rows)
            out["tp"] = {
                "all_gathers": gathers - self._mark0[1],
                "collective_s": coll_s - self._mark0[2],
                "decode_all_gathers": self._decode_gathers,
                "decode_collective_s": self._decode_collective_s,
                "all_gathers_per_decode_step":
                    self._decode_gathers / steps if steps else 0.0,
                "rows_per_rank": self._rows,
                "data": {
                    "all_gathers": data_gathers - self._mark0[3],
                    "collective_s": data_s - self._mark0[4],
                    "decode_all_gathers": self._decode_data_gathers,
                    "decode_collective_s": self._decode_data_s,
                    "all_gathers_per_decode_step":
                        self._decode_data_gathers / steps if steps
                        else 0.0}}
        return out
