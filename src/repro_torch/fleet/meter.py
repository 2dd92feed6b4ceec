"""Operational energy / CO2eq metering for the serving engine.

A fork of the JAX package's `fleet/meter.py` (plain Python), held exactly
equal to it by `tests/test_torch_fleet.py`.  On the card the engines time
each phase on the host clock after a device sync, so the meter prices
host-bound wall time with the power model: an estimate, not a measured
draw.

codecarbon-style accounting adapted to the engine's step structure: the
engine already times every phase (prefill per admission, one
decode step per tick), so the meter converts those **measured step
seconds** into Joules through a pluggable device power model, and Joules
into grams CO2eq through a `grid.GridProvider` queried on the meter's
own step clock (cumulative measured seconds — timezone-free, replayable).

Attribution is exact by construction:

  * a prefill's energy goes wholly to the admitted request;
  * a decode step's energy splits equally across the slots it advanced
    (every occupied slot emits exactly one token per step);

so the sum of per-request Joules equals the engine's cumulative total up
to float rounding — the conservation property `tests/test_torch_fleet.py`
asserts.  Metering is opt-in (`Engine(..., meter=...)`); when absent the
engine pays a single `is None` check per phase.

The default power model is TDP-based with per-phase utilization weights:
prefill is compute-bound (high utilization of the MAC array), decode is
memory-bandwidth-bound (low utilization, scaling with arena occupancy).
See the JAX package's EXPERIMENTS.md "Device power model" for the
assumptions and constants.
"""

from __future__ import annotations

import dataclasses

from repro_torch.fleet.grid import GridProvider

J_PER_KWH = 3.6e6

#: Active power per PE [W] by technology node: ballpark from ~0.5-1
#: pJ/MAC logic energy at 7 nm (Horowitz, ISSCC'14 scaling surveys,
#: int8 MAC + local SRAM access) times the node clock in
#: `core.carbon.NODE_PARAMS`, with a ~2x margin for register-file and
#: NoC share.  Older nodes pay more energy per op at a lower clock.
PE_ACTIVE_W_BY_NODE: dict[int, float] = {7: 2.0e-3, 14: 3.5e-3, 28: 6.0e-3}

#: Package power floor [W] independent of the PE array (DRAM PHY, SoC
#: fabric, always-on control) — the term that makes tiny arrays not
#: free.
BASE_POWER_W = 2.0


@dataclasses.dataclass(frozen=True)
class DevicePowerModel:
    """TDP-based device power with per-phase utilization weighting.

    `power_w` interpolates between the idle floor and TDP:

        P(phase) = P_idle + (TDP - P_idle) * util(phase)

    with `util(prefill) = prefill_util` (compute-bound, whole array
    busy) and `util(decode) = decode_util * occupancy` (bandwidth-bound
    GEMV work that scales with how many arena slots the step advanced).
    """

    tdp_w: float = 15.0
    idle_frac: float = 0.15        # idle power as a fraction of TDP
    prefill_util: float = 0.85
    decode_util: float = 0.45

    def __post_init__(self):
        if self.tdp_w <= 0:
            raise ValueError("tdp_w must be > 0")
        if not 0.0 <= self.idle_frac <= 1.0:
            raise ValueError("idle_frac must be in [0, 1]")

    @property
    def idle_w(self) -> float:
        return self.idle_frac * self.tdp_w

    def power_w(self, phase: str, n_active: int = 1,
                capacity: int = 1) -> float:
        if phase == "prefill":
            util = self.prefill_util
        elif phase == "decode":
            util = self.decode_util * (n_active / max(capacity, 1))
        else:
            raise ValueError(f"unknown phase {phase!r}")
        return self.idle_w + (self.tdp_w - self.idle_w) * util

    @classmethod
    def for_target(cls, target, **kwargs) -> "DevicePowerModel":
        """TDP from a `core.target.HardwareTarget`: the package floor
        plus per-PE active power at the die's node, summed over dies."""
        pe_w = PE_ACTIVE_W_BY_NODE[target.die.node_nm]
        return cls(tdp_w=BASE_POWER_W + target.total_pes * pe_w, **kwargs)


@dataclasses.dataclass(frozen=True)
class RequestCarbon:
    """Per-request operational footprint, attached to `Completion.carbon`."""

    energy_j: float
    co2e_g: float
    tokens: int
    region: str
    grid_g_per_kwh_mean: float     # energy-weighted mean intensity

    @property
    def energy_j_per_token(self) -> float:
        return self.energy_j / max(self.tokens, 1)

    @property
    def co2e_g_per_token(self) -> float:
        return self.co2e_g / max(self.tokens, 1)

    def to_dict(self) -> dict:
        return {"energy_j": self.energy_j, "co2e_g": self.co2e_g,
                "tokens": self.tokens, "region": self.region,
                "energy_j_per_token": self.energy_j_per_token,
                "co2e_g_per_token": self.co2e_g_per_token,
                "grid_g_per_kwh_mean": self.grid_g_per_kwh_mean}


class _Account:
    __slots__ = ("energy_j", "co2e_g")

    def __init__(self):
        self.energy_j = 0.0
        self.co2e_g = 0.0


class EnergyMeter:
    """Accumulates per-phase energy and per-request attributions.

    The meter's clock is the sum of measured step seconds it has
    observed; the grid provider is queried at the clock value *before*
    each step (start-of-step intensity), so identical step-time
    sequences give identical CO2eq regardless of when the run happens.
    `clock0_s` offsets the clock — e.g. to start a replica mid-trace.
    """

    def __init__(self, power: DevicePowerModel | None = None,
                 grid: GridProvider | None = None, *,
                 clock0_s: float = 0.0):
        from repro_torch.fleet.grid import StaticGrid
        self.power = power or DevicePowerModel()
        self.grid = grid or StaticGrid("us-east")
        self._clock_s = float(clock0_s)
        self._accounts: dict[str, _Account] = {}
        self.energy_j = 0.0
        self.co2e_g = 0.0
        self.prefill_j = 0.0
        self.decode_j = 0.0
        self.prefill_calls = 0
        self.decode_steps = 0
        self.finalized_tokens = 0
        self.finalized_co2e_g = 0.0
        self.finalized_energy_j = 0.0
        self.abandoned_requests = 0
        self.abandoned_co2e_g = 0.0
        self.abandoned_energy_j = 0.0

    @property
    def clock_s(self) -> float:
        return self._clock_s

    @property
    def region(self) -> str:
        return self.grid.region

    def g_per_kwh_now(self) -> float:
        return self.grid.g_per_kwh(self._clock_s)

    def _charge(self, request_id: str, energy_j: float, ci: float) -> None:
        acct = self._accounts.get(request_id)
        if acct is None:
            acct = self._accounts[request_id] = _Account()
        co2 = energy_j / J_PER_KWH * ci
        acct.energy_j += energy_j
        acct.co2e_g += co2
        self.energy_j += energy_j
        self.co2e_g += co2

    def on_prefill(self, request_id: str, dt_s: float) -> None:
        ci = self.g_per_kwh_now()
        e = self.power.power_w("prefill") * dt_s
        self._charge(request_id, e, ci)
        self.prefill_j += e
        self.prefill_calls += 1
        self._clock_s += dt_s

    def on_decode(self, dt_s: float, request_ids: list[str],
                  capacity: int) -> None:
        if not request_ids:
            self._clock_s += dt_s
            return
        ci = self.g_per_kwh_now()
        e = self.power.power_w("decode", len(request_ids), capacity) * dt_s
        share = e / len(request_ids)
        for rid in request_ids:
            self._charge(rid, share, ci)
        self.decode_j += e
        self.decode_steps += 1
        self._clock_s += dt_s

    def finalize(self, request_id: str, tokens: int) -> RequestCarbon:
        """Close a request's account (at eviction) and return its
        attribution; the account is dropped so re-used ids start clean."""
        acct = self._accounts.pop(request_id, None) or _Account()
        mean_ci = (acct.co2e_g / acct.energy_j * J_PER_KWH
                   if acct.energy_j > 0 else self.g_per_kwh_now())
        self.finalized_tokens += tokens
        self.finalized_co2e_g += acct.co2e_g
        self.finalized_energy_j += acct.energy_j
        return RequestCarbon(energy_j=acct.energy_j, co2e_g=acct.co2e_g,
                             tokens=tokens, region=self.region,
                             grid_g_per_kwh_mean=mean_ci)

    def abandon(self, request_id: str) -> None:
        """Close a request's account WITHOUT a completion — the failover
        path for work drained off a dead replica (the energy was really
        spent; it moves to the abandoned counters so conservation still
        holds: finalized + abandoned + open == total).  No-op for ids
        with no open account (queued-but-never-admitted requests)."""
        acct = self._accounts.pop(request_id, None)
        if acct is None:
            return
        self.abandoned_requests += 1
        self.abandoned_co2e_g += acct.co2e_g
        self.abandoned_energy_j += acct.energy_j

    def open_energy_j(self) -> float:
        """Energy charged to still-open accounts (in-flight requests)."""
        return sum(a.energy_j for a in self._accounts.values())

    def summary(self) -> dict:
        toks = max(self.finalized_tokens, 1)
        return {
            "region": self.region,
            "clock_s": self._clock_s,
            "g_per_kwh_now": self.g_per_kwh_now(),
            "energy_j": self.energy_j,
            "co2e_g": self.co2e_g,
            "prefill_j": self.prefill_j,
            "decode_j": self.decode_j,
            "prefill_calls": self.prefill_calls,
            "decode_steps": self.decode_steps,
            "finalized_tokens": self.finalized_tokens,
            "energy_j_per_token": self.finalized_energy_j / toks,
            "co2e_g_per_token": self.finalized_co2e_g / toks,
            "abandoned_requests": self.abandoned_requests,
            "abandoned_energy_j": self.abandoned_energy_j,
            "abandoned_co2e_g": self.abandoned_co2e_g,
            "finalized_energy_j": self.finalized_energy_j,
            "finalized_co2e_g": self.finalized_co2e_g,
            "open_energy_j": self.open_energy_j(),
            "power": {"tdp_w": self.power.tdp_w,
                      "idle_frac": self.power.idle_frac,
                      "prefill_util": self.power.prefill_util,
                      "decode_util": self.power.decode_util},
        }
