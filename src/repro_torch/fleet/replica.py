"""One fleet replica: a serving Engine pinned to a region.

A fork of the JAX package's `fleet/replica.py` over the port's engines.
A `Replica` owns an `Engine` or a `PagedEngine` (with its own
`HardwareTarget`, so a fleet can price different accelerator designs), a
grid-intensity provider for its region, an `EnergyMeter`, and the fault
hooks from `train/fault.py`.  Inside a world of ranks every rank builds
the same replicas and steps them alike (SPMD): a replica's engine serves
over its target's mesh (`HardwareTarget.make_mesh`: a two-die target
tensor-parallel, a one-die target with no mesh axes data-parallel over
the world's ranks) or over the `mesh` it is given, and `restart()`
rebuilds it over the same mesh.  Its decisions read ticks, tokens and
seeded draws alone; its meter prices the rank's own host-timed seconds.

  * a `StragglerWatchdog` times every replica step **on the replica's
    virtual clock** (`seconds_per_tick`, stretched by injected
    slowdowns) and flags steps that blow past the running median — the
    degradation signal the router folds into its health view.  Virtual
    timing makes straggler detection deterministic and replayable from
    a chaos seed; the wall-clock mode of the watchdog stays available
    for training via `fault.StragglerWatchdog(clock=...)`.
  * death is an *exception out of `step()`*: anything the engine raises
    (a real crash) or an injected `ReplicaDead` (tests / chaos drills)
    marks the replica dead, exactly like the crash boundary
    `fault.run_with_restarts` supervises for training.  The router then
    drains `pending_requests()` and re-queues them elsewhere — the
    fleet-level analogue of checkpoint-restart.
  * a dead replica can *recover*: `restart()` builds a fresh engine
    (weight planes re-prepared per tier via `api.prepare_params`) and a
    fresh meter that resumes the old one's grid clock; prior
    completions and meter totals are retained.  The router re-admits a
    restarted replica through probation (healthy health-check steps)
    before routing it fresh traffic.

Graceful degradation: when the engine carries a multiplier-tier ladder
(`tiers=`), a degraded replica earns *step credit* — one fleet tick
buys `area(exact) / area(tier)` engine steps (the paper's area-delay
dual read at serve time: smaller approximate multipliers mean more of
them per die, i.e. proportionally more decode throughput).  That is
what lets the `DegradationController` trade multiplier accuracy for
queue drain rate under overload instead of shedding requests.
"""

from __future__ import annotations

from typing import Callable

from repro_torch.core import multipliers as mm
from repro_torch.fleet.grid import GridProvider, StaticGrid
from repro_torch.fleet.meter import DevicePowerModel, EnergyMeter
from repro_torch.serving import Completion, Request
from repro_torch.serving.engine import Engine
from repro_torch.train import fault


class ReplicaDead(RuntimeError):
    """Raised by a replica step after `inject_fault()` (and wrapped
    around real engine crashes) — the router's failover trigger."""


def tier_speedup(name: str) -> float:
    """Decode-throughput multiple of serving on multiplier tier `name`
    relative to exact, from the multiplier library's synthesized areas:
    a tier at area ratio a fits 1/a as many multipliers in the same
    silicon, so the same die drains its decode queue 1/a x faster."""
    lib = mm.static_library()
    if name not in lib:
        return 1.0
    exact_area = lib["exact"].area_nand2eq
    return max(1.0, exact_area / max(lib[name].area_nand2eq, 1e-9))


class Replica:
    """Engine + region + meter + fault hooks, with a submit/step surface
    the router drives.

    Args:
      name: fleet-unique replica name.
      cfg: model config for the engine.
      grid: region grid-intensity provider (default: static us-east).
      power: device power model (default: derived from `target` when one
        is given, else the generic edge-TDP default).
      target: optional `HardwareTarget`; forwarded to the Engine (which
        serves over its mesh unless `mesh` is given; a mesh over more
        ranks than the process group has raises there) and to
        `DevicePowerModel.for_target`.
      seconds_per_tick: virtual-clock scale — grid lookups AND the
        straggler watchdog run on this clock (the meter uses measured
        seconds independently).
      engine_cls: engine class to build (default `Engine`; pass
        `serving.PagedEngine` for paged-KV / chunked-prefill /
        speculative replicas — `restart()` rebuilds the same class, so
        failover keeps the replica's serving mode).
      engine_kwargs: forwarded to `engine_cls(...)` (capacity, max_len,
        seed, prefill_buckets, tiers, device, and for the paged engine
        page_size, prefill_chunk, draft_tier, ...; `mesh`).
    """

    def __init__(self, name: str, cfg, *, grid: GridProvider | None = None,
                 power: DevicePowerModel | None = None, target=None,
                 seconds_per_tick: float = 1.0,
                 straggler_factor: float = 3.0,
                 on_straggler: Callable[[int, float, float], None] | None
                 = None,
                 engine_cls: type[Engine] = Engine,
                 **engine_kwargs):
        self.name = name
        self._engine_cls = engine_cls
        self.grid = grid or StaticGrid("us-east")
        if power is None:
            power = (DevicePowerModel.for_target(target)
                     if target is not None else DevicePowerModel())
        self._power = power
        self._cfg = cfg
        self._target = target
        self._engine_kwargs = dict(engine_kwargs)
        self.seconds_per_tick = seconds_per_tick
        self._straggler_factor = straggler_factor
        self._on_straggler = on_straggler
        self._retired_meters: list[EnergyMeter] = []
        self._retired_completions: list[Completion] = []
        self._tick_base = 0            # virtual ticks served by dead engines
        self.restarts = 0
        self._boot(clock0_s=0.0)
        self.alive = True
        self.routed = 0
        #: None = permanent death; K = transient (restartable K fleet
        #: ticks after the fault) — the router's recovery schedule reads
        #: this at failover time.
        self.recovery_ticks: int | None = None
        self._fault_at_step: int | None = None
        self._submit_fault = False
        self._submit_recovery: int | None = None
        self._steps = 0
        self._vtime = 0.0              # virtual seconds, watchdog timebase
        self._slow_factor = 1.0
        self._slow_steps_left = 0
        self._credit = 0.0             # fractional engine steps banked
        #: request_id -> wall (fleet) tick the replica admitted it.  The
        #: engine clock runs FASTER than the fleet clock on a degraded
        #: tier (step credit), so engine-tick TTFT understates nothing
        #: but also shows no brownout win; wall stamps are what the
        #: fleet's SLO maths must use.  Survives restarts.
        self.wall_admitted: dict[str, int] = {}

    def _boot(self, clock0_s: float) -> None:
        """(Re)build the engine + meter + watchdog — the construction
        path `restart()` re-runs, including per-tier weight-plane
        re-preparation inside the Engine."""
        self.meter = EnergyMeter(power=self._power, grid=self.grid,
                                 clock0_s=clock0_s)
        self.engine = self._engine_cls(self._cfg, target=self._target,
                                       meter=self.meter,
                                       **self._engine_kwargs)
        self.watchdog = fault.StragglerWatchdog(
            factor=self._straggler_factor, on_straggler=self._on_straggler,
            clock=lambda: self._vtime)

    # --- health / telemetry ----------------------------------------------

    @property
    def region(self) -> str:
        return self.grid.region

    @property
    def capacity(self) -> int:
        return self.engine.capacity

    @property
    def n_active(self) -> int:
        return self.engine.n_active

    @property
    def n_queued(self) -> int:
        return self.engine.n_queued

    @property
    def busy(self) -> bool:
        return bool(self.engine.n_active or self.engine.n_queued)

    @property
    def tier(self) -> str:
        return self.engine.tier

    @property
    def virtual_ticks(self) -> float:
        """Replica lifetime in virtual ticks (survives restarts)."""
        return self._tick_base + self.engine.tick

    def g_per_kwh_now(self) -> float:
        """Live intensity at the replica's virtual-tick clock."""
        return self.grid.g_per_kwh(self.virtual_ticks * self.seconds_per_tick)

    def speedup_now(self) -> float:
        """Current decode-throughput multiple from the serving tier."""
        return tier_speedup(self.engine.tier)

    def straggling(self, within_steps: int = 3) -> bool:
        """True when the watchdog flagged a straggler step recently."""
        return bool(self.watchdog.flagged) and \
            self._steps - self.watchdog.flagged[-1] <= within_steps

    # --- traffic ----------------------------------------------------------

    def submit(self, request: Request) -> None:
        if not self.alive:
            raise ReplicaDead(f"replica {self.name} is dead")
        if self._submit_fault:
            # death discovered at the submission boundary (the replica
            # died after the router's last health view): mark dead
            # FIRST so drain() works, then refuse the request — the
            # router transparently re-routes it
            self._submit_fault = False
            self.alive = False
            self.recovery_ticks = self._submit_recovery
            raise ReplicaDead(
                f"replica {self.name} died before accepting "
                f"{request.request_id!r}")
        self.routed += 1
        self.engine.submit(request)

    def step(self, now: int | None = None) -> None:
        """One *fleet* tick under the straggler watchdog.  A degraded
        tier's step credit can run several engine steps inside it; an
        injected slowdown stretches its virtual duration.  Any exception
        marks the replica dead before propagating as `ReplicaDead` — the
        router catches it and re-queues `pending_requests()`.  `now` is
        the caller's wall (fleet) tick for admission stamping; defaults
        to the replica's own step count."""
        if not self.alive:
            raise ReplicaDead(f"replica {self.name} is dead")
        wall = self._steps if now is None else now
        if self._fault_at_step is not None and \
                self._steps >= self._fault_at_step:
            self.alive = False
            self._fault_at_step = None
            raise ReplicaDead(
                f"replica {self.name}: injected fault at step "
                f"{self._steps}")
        slow = self._slow_factor if self._slow_steps_left > 0 else 1.0
        self._credit += self.speedup_now() / slow
        n_engine_steps = int(self._credit)
        self._credit -= n_engine_steps
        if not self.busy:
            # idle health-check tick: advance the engine clock once,
            # bank no credit (a burst must not get free instant steps)
            n_engine_steps = max(n_engine_steps, 1)
            self._credit = 0.0
        active_before = self.engine.active_request_ids()
        done_before = len(self.engine.completions)
        self.watchdog.step_start()
        try:
            for _ in range(n_engine_steps):
                self.engine.step()
        except Exception as e:
            self.alive = False
            raise ReplicaDead(
                f"replica {self.name} died mid-step: "
                f"{type(e).__name__}: {e}") from e
        for rid in self.engine.active_request_ids() - active_before:
            self.wall_admitted.setdefault(rid, wall)
        for c in self.engine.completions[done_before:]:
            # admitted AND finished within this wall tick (step credit)
            if c.admitted_tick >= 0:
                self.wall_admitted.setdefault(c.request_id, wall)
        self._steps += 1
        if self._slow_steps_left > 0:
            self._slow_steps_left -= 1
        self._vtime += self.seconds_per_tick * slow
        self.watchdog.step_end(self._steps)

    # --- failure / recovery ----------------------------------------------

    def inject_fault(self, at_step: int = 0,
                     recovery_ticks: int | None = None) -> None:
        """Arrange for the replica to die at its `at_step`-th future
        step (0 = the very next one) — the chaos hook the failover
        tests and the `launch/fleet.py` --kill demo use.
        `recovery_ticks=K` makes the fault *transient*: the router may
        `restart()` the replica K fleet ticks after the death (None =
        permanent)."""
        self._fault_at_step = self._steps + max(at_step, 0)
        self.recovery_ticks = recovery_ticks

    def inject_submit_fault(self, recovery_ticks: int | None = None) -> None:
        """Die at the NEXT submission instead of the next step — the
        died-since-last-health-view race the router must survive.
        `recovery_ticks` makes the death transient, as in
        `inject_fault`."""
        self._submit_fault = True
        self._submit_recovery = recovery_ticks

    def inject_slowdown(self, factor: float, steps: int = 1) -> None:
        """Stretch the next `steps` steps' virtual duration by `factor`
        (a straggling replica: thermal throttling, a noisy neighbor).
        The watchdog flags these once past `straggler_factor` x median."""
        self._slow_factor = float(factor)
        self._slow_steps_left = int(steps)

    def kill(self) -> None:
        """Mark dead immediately (out-of-band death, no step involved)."""
        self.alive = False

    def restart(self) -> None:
        """Recover from a transient death: fresh engine (weight planes
        re-prepared per tier), fresh meter resuming the retired one's
        grid clock; completions and meter totals carry over.  The
        caller (router) gates re-admission through probation."""
        if self.alive:
            raise RuntimeError(f"replica {self.name} is not dead")
        self._retired_completions.extend(self.engine.completions)
        self._retired_meters.append(self.meter)
        self._tick_base += self.engine.tick
        self._boot(clock0_s=self.meter.clock_s)
        self.alive = True
        self.restarts += 1
        self.recovery_ticks = None
        self._submit_fault = False
        self._slow_steps_left = 0
        self._credit = 0.0

    def drain(self) -> list[Request]:
        """All unfinished requests (in-flight + queued) for re-queueing
        elsewhere, FIFO by admission/arrival.  Valid on a dead replica —
        device state may be gone but the host-side request records
        survive.  Open meter accounts for the drained requests move to
        the abandoned counters (their energy was really spent here)."""
        pending = self.engine.pending_requests()
        for req in pending:
            self.meter.abandon(req.request_id)
        return pending

    def completions(self) -> list[Completion]:
        return self._retired_completions + self.engine.completions

    def carbon_summary(self) -> dict:
        """Meter summary aggregated across restarts (retired meters +
        the live one) — the fleet's conservation maths read this."""
        live = self.meter.summary()
        if not self._retired_meters:
            return live
        out = dict(live)
        for m in self._retired_meters:
            s = m.summary()
            for key in ("energy_j", "co2e_g", "prefill_j", "decode_j",
                        "prefill_calls", "decode_steps",
                        "finalized_tokens", "finalized_energy_j",
                        "finalized_co2e_g", "abandoned_requests",
                        "abandoned_energy_j", "abandoned_co2e_g",
                        "open_energy_j"):
                out[key] += s[key]
        toks = max(out["finalized_tokens"], 1)
        out["energy_j_per_token"] = out["finalized_energy_j"] / toks
        out["co2e_g_per_token"] = out["finalized_co2e_g"] / toks
        return out

    def stats(self) -> dict:
        eng = self.engine.stats()
        out = {
            "name": self.name,
            "region": self.region,
            "alive": self.alive,
            "routed": self.routed,
            "completed": len(self.completions()),
            "active": self.engine.n_active,
            "queued": self.engine.n_queued,
            "steps": self._steps,
            "restarts": self.restarts,
            "straggler_steps": list(self.watchdog.flagged),
            "g_per_kwh_now": self.g_per_kwh_now(),
            "tiers": eng["tiers"],
            "speedup_now": self.speedup_now(),
            "carbon": self.carbon_summary(),
        }
        # paged/speculative serving sections surface verbatim so the
        # router's fleet view can audit page pressure and acceptance
        for key in ("paged", "spec"):
            if key in eng:
                out[key] = eng[key]
        return out

