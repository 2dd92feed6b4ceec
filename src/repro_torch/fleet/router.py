"""Carbon-aware multi-replica router with graceful degradation.

A fork of the JAX package's `fleet/router.py`: the routing, retry and
degradation logic is host Python over tick arithmetic, unchanged.

`Fleet` fronts N `Replica`s (each an Engine in its own region, possibly
on its own `HardwareTarget`) behind one submit/step surface, and
admission-routes every request by **live grid intensity x SLO
headroom**:

  * a replica's *predicted TTFT* is estimated from its queue state
    (backlog beyond free slots x its running-mean service length /
    capacity, discounted by the serving tier's throughput speedup) —
    pure tick arithmetic, so routing is deterministic and replayable;
  * among replicas whose prediction fits the TTFT budget, the request
    goes to the **lowest-intensity** region (ties break on predicted
    wait, then name);
  * if no replica fits the budget, latency wins: the request goes to
    the fastest-draining replica regardless of carbon.

So traffic follows the cleanest grid until the SLO pushes back — the
follow-the-sun behavior `launch/fleet.py` demos under a time-varying
`TraceGrid`.

Failover & retry discipline: a replica that dies (mid-step, or at the
submission boundary after the router's last health view — both raise
`ReplicaDead`) is dropped from the live set and its unfinished requests
are drained and **re-queued with a retry budget**: attempt k re-arrives
after `retry_backoff_ticks * 2^(k-1)` fleet ticks (deterministic
tick-based exponential backoff, the request-level extension of
`fault.run_with_restarts`' attempt discipline), and a request that
exhausts `retry_budget` attempts completes as `finish_reason="shed"`
rather than vanishing — zero lost requests, exactly-once completions.
Transient deaths (`Replica.recovery_ticks`) are restarted on schedule
and re-admitted through **probation**: `probation_steps` healthy
health-check steps before the router sends them fresh traffic.

Graceful degradation (`DegradationController`): under SLO pressure
(predicted TTFT eating the budget, deep queues, straggler flags) a
replica steps DOWN its engine's multiplier-tier ladder — exact ->
approx -> aggressive-approx, each tier's weight planes prepared once at
engine build — trading bounded multiplier accuracy for decode
throughput instead of shedding load; when headroom returns it steps
back UP to exact.  Every completion records the tiers that served it,
so accuracy exposure under brownout is auditable (EXPERIMENTS.md).
"""

from __future__ import annotations

import dataclasses
import heapq
import math

from repro_torch.fleet.replica import Replica, ReplicaDead
from repro_torch.serving import Completion, Request


@dataclasses.dataclass(frozen=True)
class DegradationConfig:
    """Brownout controller knobs (all in fleet ticks / SLO fractions).

    degrade_above: step a replica DOWN one tier after `patience`
      consecutive ticks with predicted TTFT above this fraction of the
      SLO (or a fresh straggler flag).
    restore_below: step back UP one tier after `patience` consecutive
      calm ticks below this fraction (hysteresis: restore_below <
      degrade_above so the controller cannot flap on the boundary).
    patience: consecutive-signal ticks required before any step.
    min_dwell_ticks: minimum ticks between two tier changes on the same
      replica (keeps the ladder from flapping; each tier's weight
      planes are prepared once regardless).
    """
    degrade_above: float = 0.75
    restore_below: float = 0.40
    patience: int = 2
    min_dwell_ticks: int = 4

    def __post_init__(self):
        if not self.restore_below < self.degrade_above:
            raise ValueError("hysteresis requires restore_below < "
                             "degrade_above")


class DegradationController:
    """Steps each replica along its engine's multiplier-tier ladder on
    SLO-headroom / queue-depth / straggler signals.  Pure tick
    arithmetic over router-visible state — deterministic, replayable,
    and engine-agnostic (replicas without a ladder are left alone)."""

    def __init__(self, cfg: DegradationConfig | None = None):
        self.cfg = cfg or DegradationConfig()
        self._pressure: dict[str, int] = {}
        self._calm: dict[str, int] = {}
        self._last_change: dict[str, int] = {}
        self.events: list[dict] = []

    def _change(self, fleet: "Fleet", r: Replica, direction: int,
                reason: str) -> None:
        ladder = r.engine.tiers
        idx = r.engine.tier_index + direction
        target = ladder[idx]
        self.events.append({
            "tick": fleet.tick, "replica": r.name,
            "from": r.engine.tier, "to": target, "reason": reason})
        r.engine.set_tier(target)
        self._last_change[r.name] = fleet.tick
        self._pressure[r.name] = 0
        self._calm[r.name] = 0

    def step(self, fleet: "Fleet") -> None:
        cfg = self.cfg
        slo = fleet.cfg.ttft_slo_ticks
        for r in fleet.routable():
            if len(r.engine.tiers) < 2:
                continue
            pred = fleet.predicted_ttft_ticks(r)
            straggling = r.straggling()
            pressured = pred > cfg.degrade_above * slo or straggling
            calm = pred < cfg.restore_below * slo and not straggling
            self._pressure[r.name] = \
                self._pressure.get(r.name, 0) + 1 if pressured else 0
            self._calm[r.name] = \
                self._calm.get(r.name, 0) + 1 if calm else 0
            dwell_ok = fleet.tick - self._last_change.get(
                r.name, -cfg.min_dwell_ticks) >= cfg.min_dwell_ticks
            if not dwell_ok:
                continue
            if self._pressure[r.name] >= cfg.patience and \
                    r.engine.tier_index < len(r.engine.tiers) - 1:
                self._change(fleet, r, +1,
                             "straggler" if straggling else "slo_headroom")
            elif self._calm[r.name] >= cfg.patience and \
                    r.engine.tier_index > 0:
                self._change(fleet, r, -1, "headroom_restored")


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Router knobs.

    ttft_slo_ticks: admission-to-first-token budget in fleet ticks; the
      router only considers a replica "eligible" for carbon-first
      placement while its predicted TTFT fits this budget.
    default_service_ticks: prior for a replica's mean request service
      length (ticks) before it has observed any traffic.
    retry_budget: max re-queue attempts per request after failovers;
      exhausting it completes the request as "shed" (never silent loss).
    retry_backoff_ticks: base of the deterministic exponential backoff —
      attempt k re-arrives after retry_backoff_ticks * 2^(k-1) ticks.
    probation_steps: healthy health-check steps a restarted replica must
      complete before the router routes it fresh traffic.
    degradation: brownout controller knobs; None disables tier stepping
      (replicas serve their default tier forever).
    """
    ttft_slo_ticks: float = 32.0
    default_service_ticks: float = 12.0
    retry_budget: int = 3
    retry_backoff_ticks: float = 1.0
    probation_steps: int = 3
    degradation: DegradationConfig | None = None


@dataclasses.dataclass
class _RouteRecord:
    tick: int
    request_id: str
    replica: str
    g_per_kwh: float
    predicted_ttft: float
    was_lowest_carbon: bool
    requeue: bool


class Fleet:
    def __init__(self, replicas: list[Replica],
                 cfg: FleetConfig | None = None):
        if not replicas:
            raise ValueError("a fleet needs at least one replica")
        names = [r.name for r in replicas]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate replica names in {names}")
        self.replicas = list(replicas)
        self.cfg = cfg or FleetConfig()
        self.controller = (DegradationController(self.cfg.degradation)
                           if self.cfg.degradation is not None else None)
        self._pending: list[tuple[float, int, Request]] = []
        self._order = 0
        self._tick = 0
        self._submitted: set[str] = set()
        self._service_mean: dict[str, tuple[int, float]] = {
            r.name: (0, self.cfg.default_service_ticks) for r in replicas}
        self.routes: list[_RouteRecord] = []
        self.requeued = 0
        self.requeue_events: list[dict] = []
        self.retry_exhausted: list[Completion] = []
        self._recover_at: dict[str, int] = {}    # name -> due fleet tick
        self._probation: dict[str, int] = {}     # name -> healthy steps left
        self.recoveries: list[dict] = []

    # --- submission -------------------------------------------------------

    @property
    def tick(self) -> int:
        return self._tick

    def live(self) -> list[Replica]:
        return [r for r in self.replicas if r.alive]

    def routable(self) -> list[Replica]:
        """Live replicas the router may hand fresh traffic: excludes
        restarts still in probation (they step, but take no requests)."""
        return [r for r in self.replicas
                if r.alive and r.name not in self._probation]

    def submit(self, request: Request) -> None:
        """Queue a request for routing at its arrival tick (fleet
        virtual clock, mirroring the engine-trace convention)."""
        if request.request_id in self._submitted:
            raise ValueError(
                f"duplicate request_id {request.request_id!r}")
        self._submitted.add(request.request_id)
        heapq.heappush(self._pending,
                       (float(request.arrival), self._order, request))
        self._order += 1

    # --- placement policy -------------------------------------------------

    def mean_service_ticks(self, name: str) -> float:
        return self._service_mean[name][1]

    def _note_service(self, name: str, ticks: float) -> None:
        n, mean = self._service_mean[name]
        self._service_mean[name] = (n + 1, mean + (ticks - mean) / (n + 1))

    def predicted_ttft_ticks(self, r: Replica) -> float:
        """Queue-theory-lite TTFT estimate: a free slot admits next
        step (1 tick to first token); a backlogged request waits for
        `backlog` evictions, which arrive at ~capacity per mean service
        length — sped up by the serving tier's throughput multiple."""
        backlog = r.n_active + r.n_queued + 1 - r.capacity
        if backlog <= 0:
            return 1.0
        return 1.0 + backlog * self.mean_service_ticks(r.name) \
            / max(r.capacity, 1) / r.speedup_now()

    def route(self, request: Request, *,
              requeue: bool = False) -> Replica | None:
        """Pick a replica for `request` and submit it there; returns the
        chosen replica.  A replica that turns out dead at the submission
        boundary (died since the router's last health view) is failed
        over and the request is transparently retried on the remaining
        candidates — it is never lost to the race.  With every replica
        dead but recoveries scheduled, the request is deferred to the
        earliest recovery tick and None is returned."""
        while True:
            live = self.routable() or self.live()
            if not live:
                if self._recover_at:
                    due = max(min(self._recover_at.values()),
                              self._tick + 1)
                    req = dataclasses.replace(request,
                                              arrival=float(due))
                    heapq.heappush(self._pending,
                                   (req.arrival, self._order, req))
                    self._order += 1
                    return None
                raise RuntimeError(
                    f"no live replicas to serve {request.request_id!r}")
            scored = [(r, self.predicted_ttft_ticks(r), r.g_per_kwh_now())
                      for r in live]
            lowest_ci = min(ci for _, _, ci in scored)
            eligible = [(r, p, ci) for r, p, ci in scored
                        if p <= self.cfg.ttft_slo_ticks]
            if eligible:
                r, pred, ci = min(eligible,
                                  key=lambda t: (t[2], t[1], t[0].name))
            else:  # SLO unsatisfiable everywhere: minimize the damage
                r, pred, ci = min(scored,
                                  key=lambda t: (t[1], t[2], t[0].name))
            # the engine runs its own virtual clock; arrival "now"
            # admits at the replica's next step
            try:
                r.submit(dataclasses.replace(
                    request, arrival=float(r.engine.tick)))
            except ReplicaDead:
                self._failover(r)   # drains + re-queues ITS work too
                continue
            self._note_service(r.name,
                               float(request.sampling.max_new_tokens))
            self.routes.append(_RouteRecord(
                tick=self._tick, request_id=request.request_id,
                replica=r.name, g_per_kwh=ci, predicted_ttft=pred,
                was_lowest_carbon=math.isclose(ci, lowest_ci),
                requeue=requeue or request.attempt > 0))
            return r

    # --- failover / retry -------------------------------------------------

    def _requeue(self, request: Request) -> None:
        """Re-queue a drained request under the retry budget with
        deterministic tick-based exponential backoff; budget exhaustion
        completes it as "shed" (counted, never lost)."""
        attempt = request.attempt + 1
        if attempt > self.cfg.retry_budget:
            self.retry_exhausted.append(Completion(
                request_id=request.request_id,
                prompt_len=len(request.tokens), tokens=[],
                finish_reason="shed", arrival=request.arrival,
                admitted_tick=-1, finished_tick=self._tick,
                ttft_s=0.0, latency_s=0.0, carbon=None,
                attempt=request.attempt, tier_tokens={}))
            return
        delay = self.cfg.retry_backoff_ticks * (2.0 ** (attempt - 1))
        req = dataclasses.replace(request, attempt=attempt,
                                  arrival=float(self._tick) + delay)
        heapq.heappush(self._pending,
                       (req.arrival, self._order, req))
        self._order += 1

    def _failover(self, dead: Replica) -> None:
        drained = dead.drain()
        self.requeue_events.append({
            "tick": self._tick, "replica": dead.name,
            "requeued": [req.request_id for req in drained]})
        self.requeued += len(drained)
        for req in drained:
            self._requeue(req)
        if dead.recovery_ticks is not None:
            self._recover_at[dead.name] = \
                self._tick + max(int(dead.recovery_ticks), 1)

    def kill_replica(self, name: str,
                     recovery_ticks: int | None = None) -> None:
        """Out-of-band death at the current fleet tick (chaos drills /
        operator action): mark dead, fail over its work immediately,
        and schedule recovery when the death is transient.  Unlike
        `Replica.inject_fault` this fires even on an idle replica."""
        r = next(x for x in self.replicas if x.name == name)
        if not r.alive:
            return
        r.recovery_ticks = recovery_ticks
        r.kill()
        self._probation.pop(name, None)
        self._failover(r)

    def _process_recoveries(self) -> None:
        for name, due in sorted(self._recover_at.items()):
            if self._tick < due:
                continue
            del self._recover_at[name]
            r = next(x for x in self.replicas if x.name == name)
            r.restart()
            self._probation[name] = max(int(self.cfg.probation_steps), 0)
            self.recoveries.append(
                {"tick": self._tick, "replica": name,
                 "probation_steps": self._probation[name]})
            if self._probation[name] == 0:
                del self._probation[name]

    # --- the fleet loop ---------------------------------------------------

    def step(self) -> None:
        """One fleet tick: restart due recoveries, route due arrivals,
        run the degradation controller, then advance every busy live
        replica (plus probation health checks), failing over any that
        die."""
        now = self._tick
        self._process_recoveries()
        if self.live():
            while self._pending and self._pending[0][0] <= now:
                _, _, req = heapq.heappop(self._pending)
                self.route(req)
        elif self._pending and not self._recover_at:
            raise RuntimeError(
                "no live replicas and no scheduled recoveries; "
                f"{len(self._pending)} requests cannot be served")
        if self.controller is not None:
            self.controller.step(self)
        for r in self.replicas:
            probation = r.name in self._probation
            if r.alive and (r.busy or probation):
                try:
                    r.step(now=now)
                except ReplicaDead:
                    self._probation.pop(r.name, None)
                    self._failover(r)
                    continue
                if probation:
                    self._probation[r.name] -= 1
                    if self._probation[r.name] <= 0:
                        del self._probation[r.name]
        self._tick += 1

    def busy(self) -> bool:
        return bool(self._pending) or any(r.busy for r in self.live())

    def _next_wake(self) -> float | None:
        """Earliest future fleet tick with scheduled work: an arrival
        (incl. backoff re-queues) or a due recovery."""
        cands = []
        if self._pending:
            cands.append(self._pending[0][0])
        cands.extend(self._recover_at.values())
        return min(cands) if cands else None

    def run_until_complete(self) -> list[Completion]:
        """Drive the fleet until every submitted request completed
        somewhere; idle ticks fast-forward to the next scheduled work
        (arrival, backoff re-queue, or recovery)."""
        while self.busy():
            if not any(r.busy for r in self.live()):
                nxt = self._next_wake()
                if nxt is not None and nxt > self._tick:
                    self._tick = int(math.ceil(nxt))
            self.step()
        return self.completions()

    def completions(self) -> list[Completion]:
        out: list[Completion] = []
        for r in self.replicas:          # dead replicas keep finished work
            out.extend(r.completions())
        out.extend(self.retry_exhausted)
        return out

    # --- accounting -------------------------------------------------------

    def lost_requests(self) -> set[str]:
        """Submitted ids with no completion anywhere (must be empty
        after `run_until_complete`)."""
        done = {c.request_id for c in self.completions()}
        return self._submitted - done

    def wall_ttft_ticks(self) -> dict[str, float]:
        """Per-request TTFT on the *fleet* (wall) clock: replica wall
        admission stamp minus the routing tick, inclusive.  This is the
        SLO-facing metric — on a degraded tier the engine clock runs
        several ticks per fleet tick (step credit), so engine-tick TTFT
        cannot show the brownout win; wall TTFT does.  Requests that
        never reached a slot (shed / retry-exhausted) are omitted."""
        routed_at: dict[str, int] = {}
        for rec in self.routes:          # latest route = serving attempt
            routed_at[rec.request_id] = rec.tick
        out: dict[str, float] = {}
        for r in self.replicas:
            for c in r.completions():
                if c.admitted_tick < 0:
                    continue
                adm = r.wall_admitted.get(c.request_id)
                sub = routed_at.get(c.request_id)
                if adm is not None and sub is not None:
                    out[c.request_id] = float(adm - sub + 1)
        return out

    def tier_occupancy(self) -> dict[str, int]:
        """Fleet-wide tokens served per multiplier tier — the accuracy-
        exposure audit (EXPERIMENTS.md)."""
        occ: dict[str, int] = {}
        for c in self.completions():
            for tier, n in (c.tier_tokens or {}).items():
                occ[tier] = occ.get(tier, 0) + n
        return occ

    def stats(self) -> dict:
        routes = self.routes
        n_routes = max(len(routes), 1)
        totals = {"energy_j": 0.0, "co2e_g": 0.0, "tokens": 0,
                  "abandoned_energy_j": 0.0, "abandoned_co2e_g": 0.0}
        for r in self.replicas:
            s = r.carbon_summary()
            totals["energy_j"] += s["energy_j"]
            totals["co2e_g"] += s["co2e_g"]
            totals["tokens"] += s["finalized_tokens"]
            totals["abandoned_energy_j"] += s["abandoned_energy_j"]
            totals["abandoned_co2e_g"] += s["abandoned_co2e_g"]
        totals["co2e_g_per_token"] = (
            totals["co2e_g"] / max(totals["tokens"], 1))
        totals["energy_j_per_token"] = (
            totals["energy_j"] / max(totals["tokens"], 1))
        return {
            "ticks": self._tick,
            "submitted": len(self._submitted),
            "completed": len(self.completions()),
            "lost": sorted(self.lost_requests()),
            "requeued": self.requeued,
            "requeue_events": list(self.requeue_events),
            "routed": {r.name: r.routed for r in self.replicas},
            "low_carbon_share": sum(
                1 for rec in routes if rec.was_lowest_carbon) / n_routes,
            "slo": {
                "ttft_slo_ticks": self.cfg.ttft_slo_ticks,
                "predicted_ttft_max": max(
                    (rec.predicted_ttft for rec in routes), default=0.0),
            },
            "robustness": {
                "retry_budget": self.cfg.retry_budget,
                "retry_exhausted": len(self.retry_exhausted),
                "max_attempt": max(
                    (c.attempt for c in self.completions()), default=0),
                "recoveries": list(self.recoveries),
                "in_probation": sorted(self._probation),
                "restarts": {r.name: r.restarts for r in self.replicas
                             if r.restarts},
                "degradation_events": (list(self.controller.events)
                                       if self.controller else []),
                "tier_occupancy": self.tier_occupancy(),
            },
            "totals": totals,
            "replicas": [r.stats() for r in self.replicas],
        }
