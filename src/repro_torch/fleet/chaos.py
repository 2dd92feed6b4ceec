"""Deterministic chaos harness for the carbon-aware fleet.

Everything runs on the fleet's step clock: a `ChaosSchedule` is a list
of `(tick, fault)` events — replica death (permanent or transient with
recovery), death at the submission boundary, straggler slowdowns,
grid-intensity spikes, burst floods — either hand-written or drawn from
a seed (`ChaosSchedule.random`), so every campaign is replayable
bit-for-bit from `(trace, schedule seed)`.  `ChaosCampaign` drives a
`Fleet` through the schedule, lets the degradation controller cool down
after the traffic drains, and then runs the **invariant checkers**:

  * zero lost requests — every submitted id completes somewhere;
  * exactly-once — no id completes twice (failover re-queues + retry
    budget may move an attempt, never duplicate it);
  * meter conservation — per replica (across restarts), finalized +
    abandoned + open energy equals the metered total;
  * deadline accounting — shed completions carry no tokens and were
    never admitted; deadline evictions and in-budget completions
    respect their tick budgets;
  * monotone degrade/restore — tier changes move one rung at a time
    and every replica is back on its top (exact) tier after cooldown.

A fork of the JAX package's `fleet/chaos.py`.  The same campaigns run in
`tests/test_torch_fleet.py` (on the CPU, in lockstep with the JAX
package's harness) and in `chip_smoke.py`'s fleet phase on the card.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Callable, Sequence

from repro_torch.fleet.grid import GridProvider
from repro_torch.fleet.router import Fleet
from repro_torch.serving import Completion, Request, SamplingParams

FAULT_KINDS = ("kill", "transient", "submit_fault", "straggler",
               "grid_spike", "burst")


@dataclasses.dataclass(frozen=True)
class ChaosEvent:
    """One scheduled fault.  `kind` selects which knobs apply:

    kind          | knobs used
    --------------|------------------------------------------------
    kill          | replica (permanent death at `tick`)
    transient     | replica, recovery_ticks (death, then restart)
    submit_fault  | replica (dies at its next submission instead)
    straggler     | replica, factor, duration_ticks (slowdown)
    grid_spike    | replica, factor, duration_ticks (intensity x factor)
    burst         | n_requests (flood submitted at `tick`)
    """
    tick: int
    kind: str
    replica: str | None = None
    recovery_ticks: int | None = None
    factor: float = 4.0
    duration_ticks: int = 3
    n_requests: int = 8

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"one of {FAULT_KINDS}")
        if self.kind != "burst" and self.replica is None:
            raise ValueError(f"{self.kind} needs a replica name")

    def to_dict(self) -> dict:
        d = {"tick": self.tick, "kind": self.kind}
        if self.replica is not None:
            d["replica"] = self.replica
        if self.kind in ("transient", "submit_fault"):
            d["recovery_ticks"] = self.recovery_ticks
        if self.kind in ("straggler", "grid_spike"):
            d["factor"] = self.factor
            d["duration_ticks"] = self.duration_ticks
        if self.kind == "burst":
            d["n_requests"] = self.n_requests
        return d


@dataclasses.dataclass(frozen=True)
class ChaosSchedule:
    """A seeded, ordered fault schedule on the fleet step clock."""
    events: tuple[ChaosEvent, ...]
    seed: int | None = None

    @classmethod
    def random(cls, seed: int, replicas: Sequence[str], *,
               horizon_ticks: int = 24, n_events: int = 6,
               kinds: Sequence[str] = ("transient", "submit_fault",
                                       "straggler", "grid_spike", "burst"),
               ) -> "ChaosSchedule":
        """Draw `n_events` faults from `seed` (replayable: same seed,
        same schedule).  The default kind pool has no permanent "kill"
        so a random schedule can never strand work with every replica
        dead; add "kill" explicitly to the pool if the fleet keeps a
        never-killed survivor."""
        rng = random.Random(seed)
        events = []
        for _ in range(n_events):
            kind = rng.choice(list(kinds))
            tick = rng.randrange(1, max(horizon_ticks, 2))
            name = rng.choice(list(replicas))
            if kind in ("transient", "submit_fault"):
                ev = ChaosEvent(tick, kind, name,
                                recovery_ticks=rng.randrange(2, 6))
            elif kind in ("straggler", "grid_spike"):
                ev = ChaosEvent(tick, kind, name,
                                factor=float(rng.randrange(3, 8)),
                                duration_ticks=rng.randrange(2, 5))
            elif kind == "burst":
                ev = ChaosEvent(tick, kind,
                                n_requests=rng.randrange(4, 10))
            else:  # kill / submit_fault
                ev = ChaosEvent(tick, kind, name)
            events.append(ev)
        events.sort(key=lambda e: (e.tick, e.kind, e.replica or ""))
        return cls(events=tuple(events), seed=seed)


@dataclasses.dataclass(frozen=True)
class SpikedGrid:
    """A grid-intensity spike: `base` x `factor` inside [t0_s, t1_s).
    Wraps the replica's *routing* view (`Replica.grid`), so the router
    steers traffic away from the spiked region while the spike lasts;
    the meter keeps charging on its own measured-seconds clock."""
    base: GridProvider
    t0_s: float
    t1_s: float
    factor: float

    @property
    def region(self) -> str:
        return self.base.region

    def g_per_kwh(self, t_s: float) -> float:
        g = self.base.g_per_kwh(t_s)
        return g * self.factor if self.t0_s <= t_s < self.t1_s else g


def _ttft_ticks(c: Completion) -> int:
    return int(c.admitted_tick - c.arrival) + 1


def _p95(values: list) -> float:
    if not values:
        return 0.0
    vs = sorted(values)
    return float(vs[min(int(0.95 * len(vs)), len(vs) - 1)])


# --- invariant checkers ----------------------------------------------------


def check_zero_lost(fleet: Fleet, requests: dict) -> list[str]:
    lost = fleet.lost_requests()
    return [f"lost requests: {sorted(lost)}"] if lost else []


def check_exactly_once(fleet: Fleet, requests: dict) -> list[str]:
    out = []
    seen: dict[str, int] = {}
    for c in fleet.completions():
        seen[c.request_id] = seen.get(c.request_id, 0) + 1
    dupes = {rid: n for rid, n in seen.items() if n > 1}
    if dupes:
        out.append(f"duplicate completions: {dupes}")
    extra = set(seen) - set(requests)
    if extra:
        out.append(f"completions for never-submitted ids: {sorted(extra)}")
    return out


def check_meter_conservation(fleet: Fleet, requests: dict,
                             rtol: float = 1e-9) -> list[str]:
    out = []
    for r in fleet.replicas:
        s = r.carbon_summary()
        acc = (s["finalized_energy_j"] + s["abandoned_energy_j"]
               + s["open_energy_j"])
        if abs(acc - s["energy_j"]) > rtol * max(s["energy_j"], 1.0):
            out.append(
                f"{r.name}: finalized+abandoned+open {acc:.6g} J != "
                f"metered total {s['energy_j']:.6g} J")
    return out


def check_deadline_accounting(fleet: Fleet, requests: dict) -> list[str]:
    out = []
    for c in fleet.completions():
        req = requests.get(c.request_id)
        if c.finish_reason == "shed":
            if c.tokens or c.admitted_tick != -1:
                out.append(f"{c.request_id}: shed with tokens/admission")
            continue
        if c.admitted_tick < 0:
            out.append(f"{c.request_id}: {c.finish_reason} but never "
                       "admitted")
            continue
        if req is None:
            continue
        span = c.finished_tick - c.arrival + 1
        ttft = _ttft_ticks(c)
        if req.ttft_deadline_ticks is not None and \
                ttft > req.ttft_deadline_ticks:
            out.append(f"{c.request_id}: TTFT {ttft} ticks blew the "
                       f"{req.ttft_deadline_ticks}-tick budget without "
                       "being shed")
        if req.deadline_ticks is not None:
            # a degraded tier's step credit can run a few engine steps
            # per fleet tick, so the eviction lands at most one credit
            # batch past the budget
            slack = 4.0
            if span > req.deadline_ticks + slack:
                out.append(f"{c.request_id}: span {span} ticks exceeds "
                           f"deadline {req.deadline_ticks} (+{slack})")
            if c.finish_reason == "deadline" and \
                    len(c.tokens) >= req.sampling.max_new_tokens:
                out.append(f"{c.request_id}: full generation marked "
                           "'deadline'")
    return out


def check_monotone_tiers(fleet: Fleet, requests: dict) -> list[str]:
    out = []
    if fleet.controller is None:
        return out
    for ev in fleet.controller.events:
        r = next(x for x in fleet.replicas if x.name == ev["replica"])
        ladder = r.engine.tiers
        try:
            step = ladder.index(ev["to"]) - ladder.index(ev["from"])
        except ValueError:
            out.append(f"tier event off-ladder: {ev}")
            continue
        if abs(step) != 1:
            out.append(f"non-adjacent tier step: {ev}")
    for r in fleet.replicas:
        if r.alive and len(r.engine.tiers) > 1 and \
                r.engine.tier_index != 0:
            out.append(f"{r.name}: still degraded ({r.engine.tier}) "
                       "after cooldown")
    return out


CHECKERS: tuple[Callable[[Fleet, dict], list[str]], ...] = (
    check_zero_lost, check_exactly_once, check_meter_conservation,
    check_deadline_accounting, check_monotone_tiers)


# --- the campaign ----------------------------------------------------------


@dataclasses.dataclass
class ChaosReport:
    """Outcome of one campaign: what was injected, what the invariants
    said, and the headline serving metrics under chaos."""
    seed: int | None
    events_applied: list[dict]
    violations: list[str]
    faults_by_kind: dict[str, int]
    submitted: int
    completed: int
    lost: int
    requeued: int
    retry_exhausted: int
    max_attempt: int
    recoveries: int
    restarts: dict[str, int]
    shed: int
    deadline_evictions: int
    ttft_p95_ticks: float
    ttft_slo_ticks: float
    tier_occupancy: dict[str, int]
    degradation_events: int
    final_tiers: dict[str, str]

    @property
    def ok(self) -> bool:
        return not self.violations

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["ok"] = self.ok
        return d


class ChaosCampaign:
    """Drive a fleet through a request trace + fault schedule, then run
    the invariant checkers.

    Args:
      fleet: the fleet under test (fresh — the campaign owns its clock).
      trace: base request trace (submitted up front; arrivals replay on
        the fleet tick clock as usual).
      schedule: the faults to inject.
      cooldown_ticks: extra idle ticks after the traffic drains so the
        degradation controller can restore the exact tier (checked by
        the monotone-tiers invariant).
      burst_factory: builds the k-th flood request for "burst" events;
        default derives prompts/ids from the schedule seed.
    """

    def __init__(self, fleet: Fleet, trace: Sequence[Request],
                 schedule: ChaosSchedule, *, cooldown_ticks: int = 48,
                 burst_factory: Callable[[int, int], Request] | None = None):
        self.fleet = fleet
        self.trace = list(trace)
        self.schedule = schedule
        self.cooldown_ticks = cooldown_ticks
        self._burst_factory = burst_factory or self._default_burst
        self._burst_rng = random.Random(
            (schedule.seed or 0) ^ 0x5EED)
        self._burst_n = 0
        self.requests: dict[str, Request] = {}
        self.events_applied: list[dict] = []

    def _default_burst(self, tick: int, k: int) -> Request:
        prompt = [self._burst_rng.randrange(1, 256) for _ in range(8)]
        slo = self.fleet.cfg.ttft_slo_ticks
        return Request(
            request_id=f"chaos-burst-{tick}-{k}",
            tokens=prompt,
            sampling=SamplingParams(max_new_tokens=8),
            arrival=float(tick),
            ttft_deadline_ticks=4.0 * slo,
            deadline_ticks=8.0 * slo)

    def _submit(self, req: Request) -> None:
        self.requests[req.request_id] = req
        self.fleet.submit(req)

    def _apply(self, ev: ChaosEvent) -> None:
        fleet = self.fleet
        self.events_applied.append(ev.to_dict())
        if ev.kind in ("kill", "transient"):
            r = next(x for x in fleet.replicas if x.name == ev.replica)
            recovery = (ev.recovery_ticks if ev.kind == "transient"
                        else None)
            if r.alive and r.busy:
                # die INSIDE the next step — exercises the ReplicaDead-
                # out-of-step failover path, incl. mid-prefill state
                r.inject_fault(at_step=0, recovery_ticks=recovery)
            else:
                fleet.kill_replica(ev.replica, recovery_ticks=recovery)
        elif ev.kind == "submit_fault":
            r = next(x for x in fleet.replicas if x.name == ev.replica)
            if r.alive:
                r.inject_submit_fault(recovery_ticks=ev.recovery_ticks)
        elif ev.kind == "straggler":
            r = next(x for x in fleet.replicas if x.name == ev.replica)
            if r.alive:
                r.inject_slowdown(ev.factor, steps=ev.duration_ticks)
        elif ev.kind == "grid_spike":
            r = next(x for x in fleet.replicas if x.name == ev.replica)
            t0 = r.virtual_ticks * r.seconds_per_tick
            t1 = t0 + ev.duration_ticks * r.seconds_per_tick
            r.grid = SpikedGrid(base=r.grid, t0_s=t0, t1_s=t1,
                                factor=ev.factor)
        elif ev.kind == "burst":
            for _ in range(ev.n_requests):
                self._burst_n += 1
                self._submit(self._burst_factory(ev.tick, self._burst_n))

    def run(self) -> ChaosReport:
        fleet = self.fleet
        for req in self.trace:
            self._submit(req)
        events = sorted(self.schedule.events,
                        key=lambda e: (e.tick, e.kind, e.replica or ""))
        i = 0
        while fleet.busy() or i < len(events):
            while i < len(events) and events[i].tick <= fleet.tick:
                self._apply(events[i])
                i += 1
            fleet.step()
        for _ in range(self.cooldown_ticks):
            fleet.step()
        return self.report()

    def report(self) -> ChaosReport:
        fleet = self.fleet
        violations = [v for chk in CHECKERS
                      for v in chk(fleet, self.requests)]
        comps = fleet.completions()
        by_kind: dict[str, int] = {}
        for ev in self.events_applied:
            by_kind[ev["kind"]] = by_kind.get(ev["kind"], 0) + 1
        st = fleet.stats()
        rb = st["robustness"]
        return ChaosReport(
            seed=self.schedule.seed,
            events_applied=list(self.events_applied),
            violations=violations,
            faults_by_kind=by_kind,
            submitted=st["submitted"],
            completed=st["completed"],
            lost=len(st["lost"]),
            requeued=st["requeued"],
            retry_exhausted=rb["retry_exhausted"],
            max_attempt=rb["max_attempt"],
            recoveries=len(rb["recoveries"]),
            restarts=dict(rb["restarts"]),
            shed=sum(1 for c in comps if c.finish_reason == "shed"),
            deadline_evictions=sum(
                1 for c in comps if c.finish_reason == "deadline"),
            # wall-clock (fleet-tick) TTFT: the SLO-facing metric — the
            # engine clock outruns the fleet clock on degraded tiers
            ttft_p95_ticks=_p95(list(fleet.wall_ttft_ticks().values())),
            ttft_slo_ticks=fleet.cfg.ttft_slo_ticks,
            tier_occupancy=fleet.tier_occupancy(),
            degradation_events=len(rb["degradation_events"]),
            final_tiers={r.name: r.engine.tier for r in fleet.replicas},
        )
