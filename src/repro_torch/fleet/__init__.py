"""Operational-carbon fleet layer: metering, grid intensity, routing,
and the total-carbon objective.

The core package optimizes *embodied* carbon at design time (Eq. 1-2 +
the CDP GA); this package closes the serve-time half of the loop:

  * `grid.py`   — grid carbon-intensity providers (static region table,
                  replayable time-varying traces);
  * `meter.py`  — codecarbon-style energy/CO2eq metering around the
                  serving engine (per-step power model x measured step
                  time, attributed per request and per token);
  * `replica.py`/`router.py` — a multi-replica fleet driver that routes
                  by live grid intensity x SLO headroom and survives
                  replica death without losing requests: retry budgets
                  with tick-based exponential backoff, transient-crash
                  recovery with router probation, and a
                  `DegradationController` that brownouts replicas down
                  a prepared multiplier-tier ladder under SLO pressure;
  * `chaos.py`  — seeded step-clock fault schedules + invariant
                  checkers (zero lost, exactly-once, meter
                  conservation) for deterministic chaos campaigns;
  * `total.py`  — amortized-embodied + operational total-carbon
                  objective, consumed by `core/ga_batched.py` /
                  `core/codesign.py` as a scenario axis.

`grid`, `meter`, and `total` are dependency-light (numpy-free host
code); `replica`/`router` pull in the serving engine and are imported
lazily so `from repro_torch.fleet import total` stays cheap.

This package forks the JAX package's `fleet/` module for module.  The
replicas run the port's `Engine` or `PagedEngine`, on the CUDA device
unless the caller passes `device="cpu"`.
"""

from repro_torch.fleet import grid, meter, total
from repro_torch.fleet.grid import (REGION_INTENSITY_G_PER_KWH,
                                    GridProvider, StaticGrid, TraceGrid,
                                    diurnal_trace)
from repro_torch.fleet.meter import (DevicePowerModel, EnergyMeter,
                                     RequestCarbon)
from repro_torch.fleet.total import OperationalModel

__all__ = [
    "grid", "meter", "total",
    "REGION_INTENSITY_G_PER_KWH", "GridProvider", "StaticGrid",
    "TraceGrid", "diurnal_trace",
    "DevicePowerModel", "EnergyMeter", "RequestCarbon",
    "OperationalModel",
    "Fleet", "FleetConfig", "Replica", "ReplicaDead",
    "DegradationConfig", "DegradationController",
    "ChaosCampaign", "ChaosReport", "ChaosSchedule",
]

_LAZY = {"Fleet": "repro_torch.fleet.router",
         "FleetConfig": "repro_torch.fleet.router",
         "DegradationConfig": "repro_torch.fleet.router",
         "DegradationController": "repro_torch.fleet.router",
         "Replica": "repro_torch.fleet.replica",
         "ReplicaDead": "repro_torch.fleet.replica",
         "ChaosCampaign": "repro_torch.fleet.chaos",
         "ChaosReport": "repro_torch.fleet.chaos",
         "ChaosSchedule": "repro_torch.fleet.chaos",
         "router": "repro_torch.fleet.router",
         "replica": "repro_torch.fleet.replica",
         "chaos": "repro_torch.fleet.chaos"}


def __getattr__(name: str):
    if name in _LAZY:
        import importlib
        mod = importlib.import_module(_LAZY[name])
        return (mod if name in ("router", "replica", "chaos")
                else getattr(mod, name))
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
