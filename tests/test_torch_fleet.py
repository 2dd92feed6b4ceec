"""repro_torch's fleet layer on the CPU, against the JAX package's.

The oracle is split, as the reference's own suites allow here (its
engines cannot run on the installed JAX, so `test_fleet.py` and
`test_chaos.py` fail):

  * the plain-Python forks (`fleet.grid`, `fleet.meter`, `fleet.total`,
    `train.fault`, `launch.fleet.poisson_requests`) are held exactly
    equal (`==`) to the JAX package's on the same inputs;
  * the router, replica and chaos logic runs in lockstep with the JAX
    package's behind one host-only stand-in engine (`_StandIn`, built on
    each package's own request types and scheduler): the same trace
    gives equal routes, requeue events, recoveries, tier switches,
    completions and `Fleet.stats()`, and equal `ChaosReport`s;
  * the port's real engines (reduced TinyLlama, `device="cpu"`) are held
    to their own invariants — energy conservation, zero lost, tokens of
    a lone slot engine — and to the stand-in through the tick twin: a
    chaos campaign on the real engines gives the stand-in's report,
    since fleet outcomes depend only on ticks.
"""

import dataclasses
import functools
import math
import types

import numpy as np
import pytest
import torch

from repro.core import accelerator as jacc
from repro.core import multipliers as jmm
from repro.core import target as jtg
from repro.fleet import chaos as jchaos
from repro.fleet import grid as jgrid
from repro.fleet import meter as jmeter
from repro.fleet import replica as jreplica
from repro.fleet import router as jrouter
from repro.fleet import total as jtotal
from repro.launch import fleet as jlaunch
from repro.serving import scheduler as jsched
from repro.serving import types as jtypes
from repro.train import fault as jfault
from repro_torch import configs
from repro_torch.core import accelerator as acc
from repro_torch.core import multipliers as mm
from repro_torch.core import target as tg
from repro_torch.fleet import chaos, grid, meter, replica, router, total
from repro_torch.launch import fleet as launch
from repro_torch.launch import mesh as meshmod
from repro_torch.models import api
from repro_torch.serving import Engine, PagedEngine
from repro_torch.serving import scheduler as sched
from repro_torch.serving import types as stypes
from repro_torch.train import fault

torch.set_num_threads(1)

REF = types.SimpleNamespace(
    grid=jgrid, meter=jmeter, total=jtotal, fault=jfault, replica=jreplica,
    router=jrouter, chaos=jchaos, launch=jlaunch, types=jtypes,
    Scheduler=jsched.Scheduler)
PORT = types.SimpleNamespace(
    grid=grid, meter=meter, total=total, fault=fault, replica=replica,
    router=router, chaos=chaos, launch=launch, types=stypes,
    Scheduler=sched.Scheduler)
REGIONS = ("us-west", "eu-west")


# --- the forks, exactly equal -------------------------------------------------

def _raises(fn):
    try:
        fn()
    except Exception as e:      # noqa: BLE001 — the error is the result
        return type(e).__name__, str(e)
    return None


def test_grid_fork_equal():
    ts = [-5.0, 0.0, 1.0, 1799.9, 1800.0, 3600.0, 43200.0, 86399.0,
          86400.0, 1e6, 1e9]
    assert PORT.grid.REGION_INTENSITY_G_PER_KWH == \
        REF.grid.REGION_INTENSITY_G_PER_KWH
    for region in REF.grid.REGION_INTENSITY_G_PER_KWH:
        for phase in (0.0, 0.5, math.pi):
            for swing in (0.0, 0.4, 0.9):
                a = PORT.grid.diurnal_trace(region, phase=phase, swing=swing)
                b = REF.grid.diurnal_trace(region, phase=phase, swing=swing)
                assert a.values == b.values and a.period_s == b.period_s
                assert [a.g_per_kwh(t) for t in ts] == \
                    [b.g_per_kwh(t) for t in ts]
        assert [PORT.grid.StaticGrid(region).g_per_kwh(t) for t in ts] == \
            [REF.grid.StaticGrid(region).g_per_kwh(t) for t in ts]
    for wrap in (True, False):
        a = PORT.grid.TraceGrid("x", 10.0, (1.0, 2.0, 3.0), wrap=wrap)
        b = REF.grid.TraceGrid("x", 10.0, (1.0, 2.0, 3.0), wrap=wrap)
        sweep = [-1.0, 0.0, 9.99, 10.0, 25.0, 30.0, 31.0, 1e6]
        assert [a.g_per_kwh(t) for t in sweep] == \
            [b.g_per_kwh(t) for t in sweep]
    assert isinstance(PORT.grid.StaticGrid("us-east"),
                      PORT.grid.GridProvider)
    for pkg_args in (lambda g: g.StaticGrid("atlantis"),
                     lambda g: g.StaticGrid("us-east", -1.0),
                     lambda g: g.TraceGrid("x", 0.0, (1.0,)),
                     lambda g: g.TraceGrid("x", 1.0, ()),
                     lambda g: g.TraceGrid("x", 1.0, (1.0, -2.0)),
                     lambda g: g.diurnal_trace("us-west", swing=1.0)):
        got = _raises(lambda: pkg_args(PORT.grid))
        assert got is not None and got == _raises(lambda: pkg_args(REF.grid))


def _meter_calls(pkg, power_kw, grid_values):
    g = pkg.grid.TraceGrid("x", 0.5, grid_values, wrap=False)
    m = pkg.meter.EnergyMeter(power=pkg.meter.DevicePowerModel(**power_kw),
                              grid=g, clock0_s=0.25)
    rng = np.random.default_rng(0)
    out, live = [], []
    for i in range(60):
        kind = int(rng.integers(0, 5))
        if kind == 0 or not live:
            rid = f"r{i}"
            live.append(rid)
            m.on_prefill(rid, float(rng.random()))
        elif kind in (1, 2):
            k = int(rng.integers(0, len(live) + 1))
            m.on_decode(float(rng.random()) * 0.1, live[:k], capacity=4)
        elif kind == 3:
            rid = live.pop(int(rng.integers(0, len(live))))
            c = m.finalize(rid, int(rng.integers(0, 9)))
            out.append((c.energy_j, c.co2e_g, c.tokens, c.region,
                        c.grid_g_per_kwh_mean, c.energy_j_per_token,
                        c.co2e_g_per_token, c.to_dict()))
        else:
            m.abandon(live.pop(int(rng.integers(0, len(live)))))
            m.abandon("never-admitted")
    out.append(m.finalize("ghost", 1).to_dict())
    return out, m.summary(), m.open_energy_j()


@pytest.mark.parametrize("power_kw", [
    {}, dict(tdp_w=700.0, idle_frac=0.1, prefill_util=1.0,
             decode_util=0.5)])
def test_meter_fork_equal(power_kw):
    vals = (100.0, 250.0, 75.0, 400.0)
    assert _meter_calls(PORT, power_kw, vals) == \
        _meter_calls(REF, power_kw, vals)
    for pkg in (PORT, REF):
        assert pkg.meter.J_PER_KWH == 3.6e6
    assert PORT.meter.PE_ACTIVE_W_BY_NODE == REF.meter.PE_ACTIVE_W_BY_NODE
    assert PORT.meter.BASE_POWER_W == REF.meter.BASE_POWER_W
    pm, jpm = (pkg.meter.DevicePowerModel(**power_kw) for pkg in (PORT, REF))
    for args in [("prefill",), ("decode", 1, 4), ("decode", 4, 4),
                 ("decode", 3, 0)]:
        assert pm.power_w(*args) == jpm.power_w(*args)
    for bad in (lambda p: p.DevicePowerModel(tdp_w=0.0),
                lambda p: p.DevicePowerModel(idle_frac=1.5),
                lambda p: p.DevicePowerModel().power_w("train")):
        got = _raises(lambda: bad(PORT.meter))
        assert got is not None and got == _raises(lambda: bad(REF.meter))


@pytest.mark.parametrize("pes,node,n_dies", [(256, 7, 1), (1024, 14, 2),
                                             (64, 28, 4)])
def test_power_model_for_target_equal(pes, node, n_dies):
    def target(a, t):
        die = a.nvdla_default(pes, node)
        if n_dies == 1:
            return t.HardwareTarget.monolithic(die)
        return t.HardwareTarget(die, n_dies=n_dies,
                                mesh_axes=(("model", n_dies),))

    mine = PORT.meter.DevicePowerModel.for_target(target(acc, tg))
    ref = REF.meter.DevicePowerModel.for_target(target(jacc, jtg))
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)


def test_total_fork_equal():
    ops = {name: (PORT.total.OperationalModel(**kw),
                  REF.total.OperationalModel(**kw))
           for name, kw in [("default", {}),
                            ("scaled", dict(ci_use_g_per_kwh=41.0,
                                            util=0.5, idle_frac=0.3,
                                            die_w=1.5, energy_scale=2.5))]}
    assert PORT.total.LIFETIME_3Y_S == REF.total.LIFETIME_3Y_S
    for op, jop in ops.values():
        assert dataclasses.asdict(op) == dataclasses.asdict(jop)
        for fps in (0.5, 30.0, 61.0, 200.0):
            for pes in (64.0, 256.0, 1024.0):
                for escale in (0.3, 1.0):
                    for node in (7, 14, 28):
                        for fps_min in (0.0, 30.0):
                            for dies in (1.0, 2.0, 4.0):
                                a = (pes, escale, node)
                                for f in ("energy_j_per_inf",
                                          "operational_g_per_inf"):
                                    assert getattr(PORT.total, f)(
                                        fps, *a, op, fps_min, dies) == \
                                        getattr(REF.total, f)(
                                            fps, *a, jop, fps_min, dies)
                                assert PORT.total.pe_power_w(
                                    *a, op, dies) == REF.total.pe_power_w(
                                        *a, jop, dies)
                                for emb in (1e3, 1e4):
                                    assert PORT.total.total_carbon_g_per_inf(
                                        emb, fps, *a, op, fps_min, dies) == \
                                        REF.total.total_carbon_g_per_inf(
                                            emb, fps, *a, jop, fps_min, dies)
                                    assert PORT.total.embodied_g_per_inf(
                                        emb, fps, op, fps_min) == \
                                        REF.total.embodied_g_per_inf(
                                            emb, fps, jop, fps_min)
                assert PORT.total.modeled_j_per_token(
                    pes, 0.5, 14, op, fps) == REF.total.modeled_j_per_token(
                        pes, 0.5, 14, jop, fps)
        for node in (7, 14, 28):
            assert op.pe_active_w(node) == jop.pe_active_w(node)
        for measured, modeled in [(2.0, 1.0), (0.0, 1.0), (1.0, 0.0),
                                  (3.3, 1.7)]:
            c = PORT.total.EnergyCalibration(measured, modeled)
            jc = REF.total.EnergyCalibration(measured, modeled)
            assert c.scale == jc.scale
            assert dataclasses.asdict(c.apply(op)) == \
                dataclasses.asdict(jc.apply(jop))
        summary = {"energy_j_per_token": 3.0}
        assert dataclasses.asdict(PORT.total.EnergyCalibration
                                  .from_meter_summary(summary, 1.5)) == \
            dataclasses.asdict(REF.total.EnergyCalibration
                               .from_meter_summary(summary, 1.5))
    op = ops["default"]
    for bad in (lambda p, o: p.OperationalModel(ci_use_g_per_kwh=-1.0),
                lambda p, o: p.OperationalModel(util=0.0),
                lambda p, o: p.OperationalModel(lifetime_s=0.0),
                lambda p, o: p.OperationalModel(energy_scale=0.0),
                lambda p, o: p.energy_j_per_inf(0.0, 256, 1.0, 7, o),
                lambda p, o: p.modeled_j_per_token(256, 1.0, 7, o, 0.0),
                lambda p, o: o.pe_active_w(5)):
        got = _raises(lambda: bad(PORT.total, op[0]))
        assert got is not None and got == \
            _raises(lambda: bad(REF.total, op[1]))


def test_fault_fork_equal():
    rng = np.random.default_rng(4)
    durations = list(rng.exponential(1.0, 200))
    durations[60:63] = [40.0, 0.01, 55.0]

    def flagged(pkg, **kw):
        seen = []
        w = pkg.fault.StragglerWatchdog(
            on_straggler=lambda *a: seen.append(a), **kw)
        out = [w.observe(i, d) for i, d in enumerate(durations)]
        return out, w.flagged, seen

    for kw in ({}, dict(factor=2.0, window=8, min_samples=2)):
        assert flagged(PORT, **kw) == flagged(REF, **kw)
    # the clock-injected mode: a virtual clock stepping by the durations
    for pkg in (PORT, REF):
        t = [0.0]
        w = pkg.fault.StragglerWatchdog(clock=lambda: t[0])
        for i, d in enumerate(durations[:70]):
            w.step_start()
            t[0] += d
            w.step_end(i)
        pkg.res = w.flagged
    assert PORT.res == REF.res and PORT.res
    del PORT.res, REF.res

    def supervised(pkg, fails):
        sleeps, calls = [], []

        def main(attempt):
            calls.append(attempt)
            if attempt < fails:
                raise RuntimeError(f"crash {attempt}")
            return 7 + attempt

        try:
            res = pkg.fault.run_with_restarts(main, max_restarts=3,
                                              sleep=sleeps.append)
        except RuntimeError as e:
            res = str(e)
        return res, sleeps, calls

    for fails in (0, 2, 5):
        assert supervised(PORT, fails) == supervised(REF, fails)
    g = PORT.fault.PreemptionGuard()
    assert not g.preempted
    g.request()
    assert g.preempted


def test_poisson_requests_and_ttft_fork_equal():
    for seed in (0, 1, 3):
        mine = PORT.launch.poisson_requests(12, 6, 4, 512, seed=seed)
        ref = REF.launch.poisson_requests(12, 6, 4, 512, seed=seed)
        assert [dataclasses.astuple(r) for r in mine] == \
            [dataclasses.astuple(r) for r in ref]
    c = stypes.Completion("x", 3, [1, 2], "length", 2.0, 5, 7, 0.0, 0.0)
    assert PORT.launch.ttft_ticks(c) == REF.launch.ttft_ticks(c) == 4
    assert PORT.launch.DEFAULT_REGIONS == REF.launch.DEFAULT_REGIONS


# --- the stand-in engine ------------------------------------------------------

class _StandIn:
    """A host-only engine on the slot engine's tick semantics.

    Each step: shed due requests whose deadline is already blown, admit
    due requests FIFO into free slots (a prefill charged `PREFILL_S`, the
    first token emitted at the admission tick), then one decode step over
    every occupied slot (charged `DECODE_S` before the lanes emit), each
    lane emitting one token; eviction at `max_new_tokens`, at EOS, or at
    the total deadline.  Slots are taken from a free list in the slot
    engine's order.  Tokens are a fixed function of the prompt, so
    service lengths are fixed.  `pkg` supplies the request types and the
    scheduler of the package under test."""

    pkg: types.SimpleNamespace = PORT
    PREFILL_S = 0.125
    DECODE_S = 0.0625

    def __init__(self, cfg, params=None, *, capacity=4, max_len=256,
                 seed=0, tiers=None, meter=None, target=None, mesh=None,
                 device=None, prefill_buckets=None, **_):
        self.cfg, self.capacity, self.max_len = cfg, capacity, max_len
        self.meter, self.target = meter, target
        self.tiers = tuple(tiers) if tiers else ("exact",)
        self._tier = self.tiers[0]
        self._tier_tokens = {t: 0 for t in self.tiers}
        self._switches = []
        self._sched = self.pkg.Scheduler()
        self._slots = [None] * capacity
        self._free = list(range(capacity - 1, -1, -1))
        self._tick = 0
        self._admitted = 0
        self._decode_steps = 0
        self.completions = []

    # the surface the replica and the router read
    tier = property(lambda self: self._tier)
    tier_index = property(lambda self: self.tiers.index(self._tier))
    tick = property(lambda self: self._tick)
    n_active = property(lambda self: self.capacity - len(self._free))
    n_queued = property(lambda self: len(self._sched))

    def set_tier(self, name):
        if name != self._tier:
            self._switches.append({"tick": self._tick, "from": self._tier,
                                   "to": name})
            self._tier = name

    def submit(self, request):
        self._sched.submit(request)

    def pending_requests(self):
        active = sorted((s for s in self._slots if s is not None),
                        key=lambda s: s["seq"])
        return [s["req"] for s in active] + self._sched.pending()

    def active_request_ids(self):
        return {s["req"].request_id for s in self._slots if s is not None}

    def _token(self, slot):
        req = slot["req"]
        return (sum(req.tokens) * 31 + 7 * len(slot["tokens"])) % 509 + 1

    def _emit(self, i):
        slot = self._slots[i]
        slot["tokens"].append(self._token(slot))
        slot["tiers"][self._tier] = slot["tiers"].get(self._tier, 0) + 1
        self._tier_tokens[self._tier] += 1
        req, sp = slot["req"], slot["req"].sampling
        if sp.eos_id >= 0 and slot["tokens"][-1] == sp.eos_id:
            self._evict(i, "eos")
        elif len(slot["tokens"]) >= sp.max_new_tokens:
            self._evict(i, "length")
        elif req.deadline_ticks is not None and \
                self._tick - req.arrival + 1 >= req.deadline_ticks:
            self._evict(i, "deadline")

    def _carbon(self, rid, tokens):
        return None if self.meter is None else \
            self.meter.finalize(rid, tokens)

    def _evict(self, i, reason):
        slot, req = self._slots[i], self._slots[i]["req"]
        self.completions.append(self.pkg.types.Completion(
            request_id=req.request_id, prompt_len=len(req.tokens),
            tokens=slot["tokens"], finish_reason=reason,
            arrival=req.arrival, admitted_tick=slot["admitted"],
            finished_tick=self._tick, ttft_s=0.0, latency_s=0.0,
            ttft_ticks=slot["admitted"] - req.arrival + 1.0,
            carbon=self._carbon(req.request_id, len(slot["tokens"])),
            attempt=req.attempt, tier_tokens=dict(slot["tiers"])))
        self._slots[i] = None
        self._free.append(i)

    def step(self):
        now = self._tick
        self._sched.note_ready(now, 0.0)
        for req in self._sched.pop_expired(now):
            self._sched._ready_wall.pop(req.request_id, None)
            self.completions.append(self.pkg.types.Completion(
                request_id=req.request_id, prompt_len=len(req.tokens),
                tokens=[], finish_reason="shed", arrival=req.arrival,
                admitted_tick=-1, finished_tick=self._tick, ttft_s=0.0,
                latency_s=0.0, carbon=self._carbon(req.request_id, 0),
                attempt=req.attempt, tier_tokens={}))
        while self._free:
            req = self._sched.pop_ready(now)
            if req is None:
                break
            self._sched.ready_wall(req.request_id)
            i = self._free.pop()
            if self.meter is not None:
                self.meter.on_prefill(req.request_id, self.PREFILL_S)
            self._admitted += 1
            self._slots[i] = {"req": req, "tokens": [], "tiers": {},
                              "admitted": now, "seq": self._admitted}
            self._emit(i)
        lanes = [i for i, s in enumerate(self._slots) if s is not None]
        if lanes:
            self._decode_steps += 1
            if self.meter is not None:
                self.meter.on_decode(
                    self.DECODE_S,
                    [self._slots[i]["req"].request_id for i in lanes],
                    self.capacity)
            for i in lanes:
                if self._slots[i] is not None:
                    self._emit(i)
        self._tick += 1

    def stats(self):
        out = {"ticks": self._tick, "decode_steps": self._decode_steps,
               "admitted": self._admitted,
               "completed": len(self.completions),
               "tiers": {"active": self._tier, "ladder": list(self.tiers),
                         "tokens": dict(self._tier_tokens),
                         "switches": list(self._switches)}}
        if self.meter is not None:
            out["carbon"] = self.meter.summary()
        return out


class _RefStandIn(_StandIn):
    pkg = REF


class _PortStandIn(_StandIn):
    pkg = PORT


STANDIN = {id(REF): _RefStandIn, id(PORT): _PortStandIn}
CFG = types.SimpleNamespace(name="standin", vocab=512)


def _fleet(pkg, *, capacity=2, slo=32.0, tiers=None, names=REGIONS,
           fleet_kw=None, diurnal=False, engine_cls=None, cfg=CFG,
           **engine_kw):
    reps = []
    for i, name in enumerate(names):
        g = pkg.grid.diurnal_trace(name, phase=i / len(names)) if diurnal \
            else pkg.grid.StaticGrid(name)
        reps.append(pkg.replica.Replica(
            name, cfg, grid=g, seconds_per_tick=1800.0 if diurnal else 1.0,
            engine_cls=engine_cls or STANDIN[id(pkg)], capacity=capacity,
            max_len=48, seed=0, tiers=tiers, **engine_kw))
    return pkg.router.Fleet(reps, pkg.router.FleetConfig(
        ttft_slo_ticks=slo, **(fleet_kw or {})))


def _req(pkg, rid, n, seed, gen, arrival=0.0, **kw):
    return pkg.types.Request(
        rid, np.random.default_rng(seed).integers(1, 512, (n,)).tolist(),
        pkg.types.SamplingParams(max_new_tokens=gen), arrival=arrival, **kw)


def _completion(c):
    return (c.request_id, tuple(c.tokens), c.finish_reason, c.arrival,
            c.admitted_tick, c.finished_tick, c.attempt, c.tier_tokens,
            c.ttft_ticks, None if c.carbon is None else c.carbon.to_dict())


def _outcome(fleet):
    """Everything the router, replicas and controller decided."""
    return {
        "routes": [dataclasses.astuple(r) for r in fleet.routes],
        "requeue_events": fleet.requeue_events,
        "recoveries": fleet.recoveries,
        "tier_events": fleet.controller.events if fleet.controller else [],
        "completions": [_completion(c) for c in fleet.completions()],
        "wall_admitted": [r.wall_admitted for r in fleet.replicas],
        "wall_ttft": fleet.wall_ttft_ticks(),
        "stragglers": [r.watchdog.flagged for r in fleet.replicas],
        "alive": [r.alive for r in fleet.replicas],
        "tick": fleet.tick,
        "stats": fleet.stats(),
    }


# --- lockstep scenarios (tests/test_fleet.py, tests/test_chaos.py) -----------

def _route_then_spill(pkg):
    fleet = _fleet(pkg, capacity=1, slo=1.5)
    r0 = fleet.route(_req(pkg, "a", 4, 0, 4))
    assert r0.name == "us-west" and fleet.routes[0].was_lowest_carbon
    assert fleet.mean_service_ticks("us-west") == 4.0
    pred = fleet.predicted_ttft_ticks(r0)
    assert pred > 1.5
    r1 = fleet.route(_req(pkg, "b", 4, 1, 4))
    assert r1.name == "eu-west" and not fleet.routes[1].was_lowest_carbon
    fleet.run_until_complete()
    return dict(_outcome(fleet), pred=pred)


def _diurnal_trace(pkg):
    fleet = _fleet(pkg, diurnal=True)
    for r in pkg.launch.poisson_requests(10, 6, 4, 512, seed=3):
        fleet.submit(r)
    fleet.run_until_complete()
    assert not fleet.lost_requests()
    return _outcome(fleet)


def _failover(pkg):
    fleet = _fleet(pkg)
    for r in pkg.launch.poisson_requests(10, 6, 6, 512, seed=0):
        fleet.submit(r)
    fleet.replicas[0].inject_fault(at_step=3)
    fleet.run_until_complete()
    s = fleet.stats()
    assert not fleet.replicas[0].alive and s["requeued"] >= 1
    assert s["lost"] == [] and s["completed"] == 10
    assert all(rec.replica == "eu-west" for rec in fleet.routes
               if rec.requeue)
    return _outcome(fleet)


def _submit_fault(pkg):
    fleet = _fleet(pkg)
    fleet.replicas[0].inject_submit_fault()
    r = fleet.route(_req(pkg, "x", 5, 0, 3))
    assert r.name == "eu-west" and not fleet.replicas[0].alive
    fleet.run_until_complete()
    assert [c.request_id for c in fleet.completions()] == ["x"]
    return _outcome(fleet)


def _drain_fifo(pkg):
    fleet = _fleet(pkg, slo=1000.0)
    for i in range(5):
        fleet.route(_req(pkg, f"r{i}", 5, i, 6))
    fleet.step()
    preview = [r.request_id
               for r in fleet.replicas[0].engine.pending_requests()]
    assert preview == [f"r{i}" for i in range(5)]
    fleet.kill_replica("us-west")
    fleet.run_until_complete()
    assert fleet.requeue_events[-1]["requeued"] == preview
    return _outcome(fleet)


def _retry_exhausted(pkg):
    fleet = _fleet(pkg, fleet_kw=dict(retry_budget=0))
    fleet.submit(_req(pkg, "doomed", 5, 0, 4))
    fleet.step()
    fleet.kill_replica(next(r for r in fleet.replicas if r.routed).name)
    fleet.run_until_complete()
    (c,) = fleet.completions()
    assert c.finish_reason == "shed" and c.tokens == []
    return _outcome(fleet)


def _backoff(pkg):
    fleet = _fleet(pkg, fleet_kw=dict(retry_budget=3,
                                      retry_backoff_ticks=2.0))
    base = _req(pkg, "b", 4, 0, 2)
    for attempt in (0, 1, 2, 3):
        fleet._requeue(dataclasses.replace(base, attempt=attempt))
    pending = sorted((t, req.attempt) for t, _, req in fleet._pending)
    assert pending == [(2.0, 1), (4.0, 2), (8.0, 3)]
    fleet.run_until_complete()
    return dict(_outcome(fleet), pending=pending)


def _probation(pkg):
    fleet = _fleet(pkg, fleet_kw=dict(probation_steps=2))
    for r in pkg.launch.poisson_requests(6, 5, 4, 512, seed=2):
        fleet.submit(r)
    fleet.step()
    fleet.kill_replica("us-west", recovery_ticks=3)
    fleet.run_until_complete()
    assert fleet.replicas[0].alive and fleet.replicas[0].restarts == 1
    fleet.submit(_req(pkg, "after", 5, 8, 3, arrival=float(fleet.tick)))
    fleet.run_until_complete()
    assert not fleet.lost_requests()
    return _outcome(fleet)


def _brownout(pkg):
    fleet = _fleet(pkg, capacity=1, slo=6.0, names=("us-west",),
                   tiers=("exact", "trunc4x4"),
                   fleet_kw=dict(degradation=pkg.router.DegradationConfig(
                       patience=1, min_dwell_ticks=2)))
    for i in range(6):
        fleet.submit(_req(pkg, f"b{i}", 5, i, 5))
    fleet.run_until_complete()
    for _ in range(10):
        fleet.step()
    ev = fleet.controller.events
    assert ev[0]["to"] == "trunc4x4" and ev[-1]["to"] == "exact"
    assert fleet.tier_occupancy()["trunc4x4"] > 0
    return _outcome(fleet)


def _straggler(pkg):
    fleet = _fleet(pkg, tiers=("exact", "trunc2x2", "trunc4x4"),
                   fleet_kw=dict(degradation=pkg.router.DegradationConfig(
                       patience=1, min_dwell_ticks=1)))
    for i in range(12):
        fleet.submit(_req(pkg, f"s{i}", 5, i, 8))
    for _ in range(8):
        fleet.step()
    fleet.replicas[0].inject_slowdown(6.0, steps=3)
    fleet.run_until_complete()
    for _ in range(12):
        fleet.step()
    assert fleet.replicas[0].watchdog.flagged
    assert any(e["reason"] == "straggler" for e in fleet.controller.events)
    return _outcome(fleet)


def _idle_fast_forward(pkg):
    fleet = _fleet(pkg)
    fleet.submit(_req(pkg, "late", 4, 0, 3, arrival=100.0))
    fleet.run_until_complete()
    assert 100 <= fleet.tick < 120
    return _outcome(fleet)


def _tiered_fleet(pkg, slo=32.0, **kw):
    return _fleet(pkg, slo=slo, tiers=("exact", "trunc4x4"), fleet_kw=dict(
        retry_budget=3, probation_steps=2,
        degradation=pkg.router.DegradationConfig(patience=1,
                                                 min_dwell_ticks=2)), **kw)


def _chaos_trace(pkg, n=8, gen=4, slo=32.0):
    return [dataclasses.replace(r, ttft_deadline_ticks=4.0 * slo,
                                deadline_ticks=8.0 * slo)
            for r in pkg.launch.poisson_requests(n, 6, gen, 512, seed=1)]


def _campaign(pkg, schedule_fn, trace_fn=_chaos_trace, slo=32.0,
              cooldown=48, fleet_fn=None):
    fleet = (fleet_fn or _tiered_fleet)(pkg, slo=slo)
    schedule = schedule_fn(pkg, [r.name for r in fleet.replicas])
    report = pkg.chaos.ChaosCampaign(fleet, trace_fn(pkg), schedule,
                                     cooldown_ticks=cooldown).run()
    return report, fleet


def _hand_transient(pkg):
    report, fleet = _campaign(
        pkg, lambda p, names: p.chaos.ChaosSchedule(events=(
            p.chaos.ChaosEvent(2, "transient", "us-west",
                               recovery_ticks=3),), seed=0),
        trace_fn=lambda p: _chaos_trace(p, n=6), cooldown=16)
    assert report.ok and report.restarts == {"us-west": 1}
    return dict(_outcome(fleet), report=report.to_dict())


def _burst_brownout(pkg):
    report, fleet = _campaign(
        pkg, lambda p, names: p.chaos.ChaosSchedule(events=(
            p.chaos.ChaosEvent(1, "burst", n_requests=10),), seed=5),
        trace_fn=lambda p: [], slo=16.0, cooldown=24)
    assert report.ok and report.degradation_events >= 2
    assert report.tier_occupancy.get("trunc4x4", 0) > 0
    assert all(t == "exact" for t in report.final_tiers.values())
    return dict(_outcome(fleet), report=report.to_dict())


def _grid_spike(pkg):
    report, fleet = _campaign(
        pkg, lambda p, names: p.chaos.ChaosSchedule(events=(
            p.chaos.ChaosEvent(0, "grid_spike", "us-west", factor=4.0,
                               duration_ticks=64),), seed=3),
        trace_fn=lambda p: [_req(p, f"g{i}", 5, i, 3, arrival=float(i))
                            for i in range(4)], cooldown=4)
    assert report.ok
    assert all(rec.replica == "eu-west" for rec in fleet.routes)
    return dict(_outcome(fleet), report=report.to_dict())


SCENARIOS = [_route_then_spill, _diurnal_trace, _failover, _submit_fault,
             _drain_fifo, _retry_exhausted, _backoff, _probation, _brownout,
             _straggler, _idle_fast_forward, _hand_transient,
             _burst_brownout, _grid_spike]


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[f.__name__[1:] for f in SCENARIOS])
def test_fleet_lockstep_with_reference(scenario):
    mine, ref = scenario(PORT), scenario(REF)
    assert mine.keys() == ref.keys()
    for key in mine:
        assert mine[key] == ref[key], key


CHAOS_SEEDS = [7, 11, 23, 42]


def _random_schedule(seed):
    return lambda p, names: p.chaos.ChaosSchedule.random(seed, names)


@pytest.mark.parametrize("seed", CHAOS_SEEDS)
def test_chaos_report_lockstep_with_reference(seed):
    mine, mf = _campaign(PORT, _random_schedule(seed))
    ref, rf = _campaign(REF, _random_schedule(seed))
    assert mine.to_dict() == ref.to_dict()
    assert _outcome(mf) == _outcome(rf)
    assert mine.ok, mine.violations
    assert len(mine.faults_by_kind) >= 3


def test_chaos_seeds_cover_the_default_pool():
    kinds = set()
    for seed in CHAOS_SEEDS:
        mine = PORT.chaos.ChaosSchedule.random(seed, REGIONS)
        ref = REF.chaos.ChaosSchedule.random(seed, REGIONS)
        assert [e.to_dict() for e in mine.events] == \
            [e.to_dict() for e in ref.events]
        kinds |= {e.kind for e in mine.events}
    assert kinds == {"transient", "submit_fault", "straggler", "grid_spike",
                     "burst"}
    assert PORT.chaos.FAULT_KINDS == REF.chaos.FAULT_KINDS
    for bad in (lambda c: c.ChaosEvent(1, "meteor", "a"),
                lambda c: c.ChaosEvent(1, "straggler")):
        got = _raises(lambda: bad(PORT.chaos))
        assert got is not None and got == _raises(lambda: bad(REF.chaos))
    base = PORT.grid.StaticGrid("us-west")
    spiked = PORT.chaos.SpikedGrid(base=base, t0_s=10.0, t1_s=20.0,
                                   factor=4.0)
    jspiked = REF.chaos.SpikedGrid(base=REF.grid.StaticGrid("us-west"),
                                   t0_s=10.0, t1_s=20.0, factor=4.0)
    ts = [5.0, 10.0, 19.99, 20.0]
    assert [spiked.g_per_kwh(t) for t in ts] == \
        [jspiked.g_per_kwh(t) for t in ts]
    assert spiked.region == "us-west" and len(PORT.chaos.CHECKERS) == 5


def test_tier_speedup_equal():
    for name in list(mm.static_library()) + ["unknown"]:
        assert PORT.replica.tier_speedup(name) == \
            REF.replica.tier_speedup(name)
    assert set(mm.static_library()) == set(jmm.static_library())


# --- the port's real engines on the CPU ---------------------------------------

OVER = dict(mult="trunc2x2", kernel_policy="pallas", attn_impl="flash")


@functools.lru_cache(maxsize=None)
def _setup():
    cfg = configs.reduced(configs.get_config("tinyllama-1.1b"), **OVER)
    return cfg, api.init_params(cfg, 0, "cpu")


class _AuditedMeter(meter.EnergyMeter):
    """A meter that checks, at every decode charge, that no charged
    request is still prefilling in chunks."""

    engine = None

    def on_decode(self, dt_s, request_ids, capacity):
        slots = {s.request.request_id: s for s in self.engine._slots
                 if s is not None}
        assert not any(getattr(slots[rid], "prefilling", False)
                       for rid in request_ids)
        self.charged = getattr(self, "charged", 0) + len(request_ids)
        super().on_decode(dt_s, request_ids, capacity)


def _trace(cfg, n=5):
    rng = np.random.default_rng(5)
    return [stypes.Request(
        f"m{i}", rng.integers(1, cfg.vocab, int(rng.integers(4, 20))
                              ).tolist(),
        stypes.SamplingParams(max_new_tokens=int(rng.integers(2, 6))),
        arrival=float(i)) for i in range(n)]


@pytest.mark.parametrize("kind", ["slot", "paged_chunked", "paged_spec"])
def test_metered_engines_conserve_energy(kind):
    cfg, params = _setup()
    m = _AuditedMeter(power=meter.DevicePowerModel(tdp_w=700.0),
                      grid=grid.diurnal_trace("eu-west"))
    kw = dict(capacity=2, max_len=48, seed=0, device="cpu", meter=m)
    if kind == "slot":
        eng = Engine(cfg, params, **kw)
    elif kind == "paged_chunked":
        eng = PagedEngine(cfg, params, page_size=8, prefill_chunk=6, **kw)
    else:
        eng = PagedEngine(cfg, params, page_size=8, draft_tier="trunc4x4",
                          spec_k=2, **kw)
    m.engine = eng
    trace = _trace(cfg)
    for r in trace:
        eng.submit(r)
    done = eng.run_until_complete()
    st = eng.stats()
    assert len(done) == len(trace)
    total_j = sum(c.carbon.energy_j for c in done)
    total_g = sum(c.carbon.co2e_g for c in done)
    assert total_j > 0
    assert abs(total_j - m.energy_j) <= 1e-9 * m.energy_j
    assert abs(total_g - m.co2e_g) <= 1e-9 * m.co2e_g
    for c in done:
        assert c.carbon.tokens == len(c.tokens) and c.carbon.energy_j > 0
        assert c.carbon.region == "eu-west"
    s = st["carbon"]
    assert s["open_energy_j"] == 0.0 and s["finalized_tokens"] == sum(
        len(c.tokens) for c in done)
    assert s["energy_j"] == pytest.approx(s["prefill_j"] + s["decode_j"],
                                          rel=1e-12)
    # one charge per prefill call and per decode step, each lane once
    chunks = st.get("paged", {}).get("chunked", {}).get("chunks", 0)
    assert s["prefill_calls"] == st["admitted"] + (
        chunks - sum(len(r.tokens) > 6 for r in trace) if chunks else 0)
    assert s["decode_steps"] == st["decode_steps"]
    if kind == "paged_chunked":
        assert chunks > 0
    if kind == "paged_spec":
        assert st["spec"]["steps"] == st["decode_steps"] > 0
    else:
        # every emitted token but the prefill's came from a charged lane
        assert m.charged == sum(len(c.tokens) - 1 for c in done)


@pytest.mark.parametrize("cls", [Engine, PagedEngine])
def test_engine_without_meter_has_no_carbon(cls):
    cfg, params = _setup()
    eng = cls(cfg, params, capacity=2, max_len=48, device="cpu")
    eng.submit(_trace(cfg, 1)[0])
    (c,) = eng.run_until_complete()
    assert c.carbon is None and "carbon" not in eng.stats()


def test_engine_refuses_a_mesh_or_a_multi_die_target():
    """Outside a process group of the mesh's size, a multi-die target (or
    a mesh spec over more ranks) raises `ValueError` naming both sizes;
    inside one, the engine serves tensor-parallel, token for token as one
    device (the target's world of two ranks)."""
    cfg, params = _setup()
    die = acc.nvdla_default(256, 7)
    two = tg.HardwareTarget(die, n_dies=2, mesh_axes=(("model", 2),))
    data = tg.HardwareTarget.monolithic(die, data=2)
    for make in (lambda: Engine(cfg, params, device="cpu", target=two),
                 lambda: Engine(cfg, params, device="cpu", target=data),
                 lambda: Engine(cfg, params, device="cpu",
                                mesh=meshmod.make_mesh_from_spec("model=2"))):
        with pytest.raises(ValueError, match=r"spans 2 ranks but the "
                                             r"process group has 1"):
            make()
    import torch_tp_ranks as R
    got, other = meshmod.spawn(R.target_world, "model=2", device="cpu",
                                timeout_s=120.0)
    tcfg, tparams = R.model("tinyllama-1.1b", "trunc2x2")
    assert got == other
    assert got["stats"]["mesh"] == {"data": 1, "model": 2}
    assert got["done"] == R.serve(tcfg, tparams)["done"]
    one = tg.HardwareTarget.monolithic(die)
    rep = replica.Replica("a", cfg, target=one, params=params, capacity=1,
                          max_len=32, device="cpu")
    assert rep.engine.target is one
    assert rep.meter.power == meter.DevicePowerModel.for_target(one)


def _lone_tokens(cfg, params, reqs):
    eng = Engine(cfg, params, capacity=2, max_len=48, device="cpu")
    for r in reqs:
        eng.submit(dataclasses.replace(r, arrival=0.0))
    return {c.request_id: c.tokens for c in eng.run_until_complete()}


def _conserves(fleet):
    return PORT.chaos.check_meter_conservation(fleet, {}) == []


def test_failover_loses_nothing_and_matches_a_lone_engine():
    cfg, params = _setup()
    fleet = launch.build_fleet(cfg, trace="static", capacity=2, max_len=48,
                               params=params, device="cpu")
    reqs = launch.poisson_requests(8, 6, 6, cfg.vocab, seed=0)
    for r in reqs:
        fleet.submit(r)
    fleet.replicas[0].inject_fault(at_step=3)
    comps = fleet.run_until_complete()
    s = fleet.stats()
    assert s["lost"] == [] and s["requeued"] >= 1
    assert sorted(c.request_id for c in comps) == sorted(
        r.request_id for r in reqs)
    assert {c.request_id: c.tokens for c in comps} == \
        _lone_tokens(cfg, params, reqs)
    assert _conserves(fleet)


def test_paged_replica_fails_over_and_restarts_as_paged():
    cfg, params = _setup()
    fleet = _fleet(PORT, engine_cls=PagedEngine, cfg=cfg, params=params,
                   device="cpu", page_size=8, prefill_chunk=4,
                   fleet_kw=dict(probation_steps=1))
    reqs = launch.poisson_requests(6, 6, 5, cfg.vocab, seed=2)
    for r in reqs:
        fleet.submit(r)
    fleet.step()
    fleet.step()
    fleet.kill_replica("us-west", recovery_ticks=2)
    comps = fleet.run_until_complete()
    rep = fleet.replicas[0]
    assert rep.alive and rep.restarts == 1
    assert all(type(r.engine) is PagedEngine for r in fleet.replicas)
    assert fleet.requeue_events[0]["requeued"]
    assert not fleet.lost_requests()
    assert {c.request_id: c.tokens for c in comps} == \
        _lone_tokens(cfg, params, reqs)
    assert _conserves(fleet)


def _real_tiered_fleet(engine_cls, **kw):
    cfg, params = _setup()
    return lambda pkg, slo=32.0: _tiered_fleet(
        pkg, slo, engine_cls=engine_cls, cfg=cfg, params=params,
        device="cpu", **kw)


@pytest.mark.parametrize("engine_cls,kw", [
    (Engine, {}), (PagedEngine, dict(page_size=8))],
    ids=["slot", "paged"])
def test_chaos_on_real_engines_is_the_standin_tick_twin(engine_cls, kw):
    """Seed 7's campaign on the port's real engines (the slot engine, and
    the paged engine without chunks or drafts, whose ticks are the slot
    engine's): every invariant holds, two runs give one report, and the
    report equals the stand-in's for the same trace and schedule."""
    fleet_fn = _real_tiered_fleet(engine_cls, **kw)
    runs = [_campaign(PORT, _random_schedule(7),
                      fleet_fn=fleet_fn)[0].to_dict() for _ in range(2)]
    twin, _ = _campaign(PORT, _random_schedule(7))
    assert runs[0]["ok"], runs[0]["violations"]
    assert runs[0] == runs[1] == twin.to_dict()
    assert runs[0]["recoveries"] >= 1 and runs[0]["requeued"] >= 1


def test_fleet_cli_on_the_cpu(capsys):
    rc = launch.main(["--reduced", "--device", "cpu", "--kill", "3",
                      "--requests", "6", "--gen", "4"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "lost=0 (ZERO-LOST OK)" in out and "replicas on cpu" in out
