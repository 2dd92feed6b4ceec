"""Grid carbon-intensity providers.

A fork of the JAX package's `fleet/grid.py` (plain Python, no JAX), held
exactly equal to it by `tests/test_torch_fleet.py`.

A provider answers one question: *how many grams of CO2-equivalent does
one kWh drawn from this region's grid emit at time t?*  Time is a plain
float of seconds on a region-local **step clock** that starts at 0 —
never a wall-clock timestamp — so traces replay deterministically in
tests and benchmarks regardless of host timezone or run date.  Callers
pick the clock: the energy meter advances its clock by measured step
seconds; the fleet router queries at its virtual tick time.

Two implementations:

  * `StaticGrid` — a constant intensity from the sourced region table
    (annual averages; the right model for design-time scenario sweeps);
  * `TraceGrid` — a replayable piecewise-constant trace (the right model
    for testing carbon-aware routing, where the *ordering* of intensity
    crossings is what the router reacts to).  `diurnal_trace` builds the
    canonical day-curve shape.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Protocol, Sequence, runtime_checkable

#: Region -> grid carbon intensity [g CO2eq / kWh], 2023 annual averages
#: (generation-based) from Ember's Electricity Data Explorer country
#: figures (ember-climate.org, "Carbon intensity of electricity", 2023),
#: rounded.  Region keys follow cloud-region naming; the mapped country
#: is in the comment.  These are *scenario constants*, not live signals:
#: a deployment would substitute an API-backed provider with the same
#: `g_per_kwh(t_s)` surface.
REGION_INTENSITY_G_PER_KWH: dict[str, float] = {
    "eu-north":   41.0,    # Sweden (hydro + nuclear)
    "ca-east":   130.0,    # Canada (Quebec hydro-dominated national mix)
    "us-west":   263.0,    # California
    "eu-west":   346.0,    # Ireland
    "us-east":   379.0,    # United States (Virginia ~ national average)
    "eu-central": 381.0,   # Germany
    "ap-northeast": 485.0,  # Japan
    "ap-east":   561.0,    # Taiwan
    "ap-south":  713.0,    # India (coal-heavy)
}


@runtime_checkable
class GridProvider(Protocol):
    """Minimal provider surface: a region label and an intensity curve
    over a region-local step clock (seconds since clock start)."""

    region: str

    def g_per_kwh(self, t_s: float) -> float: ...


@dataclasses.dataclass(frozen=True)
class StaticGrid:
    """Constant intensity; built from the region table by default."""

    region: str
    intensity_g_per_kwh: float | None = None

    def __post_init__(self):
        if self.intensity_g_per_kwh is None:
            if self.region not in REGION_INTENSITY_G_PER_KWH:
                raise ValueError(
                    f"unknown region {self.region!r}; pass "
                    f"intensity_g_per_kwh= or use one of "
                    f"{sorted(REGION_INTENSITY_G_PER_KWH)}")
            object.__setattr__(self, "intensity_g_per_kwh",
                               REGION_INTENSITY_G_PER_KWH[self.region])
        if self.intensity_g_per_kwh <= 0:
            raise ValueError("grid intensity must be > 0 g/kWh")

    def g_per_kwh(self, t_s: float) -> float:
        return self.intensity_g_per_kwh


@dataclasses.dataclass(frozen=True)
class TraceGrid:
    """Replayable piecewise-constant intensity trace.

    `values[i]` holds on `[i * step_s, (i + 1) * step_s)`; with
    `wrap=True` (default) the trace repeats, otherwise the last value
    holds forever.  Negative times clamp to the first sample rather than
    raising — a replica's clock may lag the router's by a warmup step.
    """

    region: str
    step_s: float
    values: tuple[float, ...]

    wrap: bool = True

    def __post_init__(self):
        if self.step_s <= 0:
            raise ValueError("step_s must be > 0")
        vals = tuple(float(v) for v in self.values)
        if not vals:
            raise ValueError("TraceGrid needs at least one sample")
        if any(v <= 0 for v in vals):
            raise ValueError("grid intensities must be > 0 g/kWh")
        object.__setattr__(self, "values", vals)

    def g_per_kwh(self, t_s: float) -> float:
        i = int(max(t_s, 0.0) // self.step_s)
        if self.wrap:
            i %= len(self.values)
        else:
            i = min(i, len(self.values) - 1)
        return self.values[i]

    @property
    def period_s(self) -> float:
        return self.step_s * len(self.values)


def diurnal_trace(region: str, *, mean_g_per_kwh: float | None = None,
                  swing: float = 0.4, period_s: float = 86400.0,
                  samples: int = 24, phase: float = 0.0) -> TraceGrid:
    """Sinusoidal day curve sampled into a `TraceGrid`: intensity peaks
    mid-trace (evening fossil ramp) and bottoms out a half-period away
    (solar noon), `swing` being the peak deviation as a fraction of the
    mean.  `phase` (radians) shifts the curve — two regions with opposed
    phases model the time-zone offset that makes follow-the-sun routing
    worthwhile."""
    mean = (REGION_INTENSITY_G_PER_KWH[region]
            if mean_g_per_kwh is None else mean_g_per_kwh)
    if not 0.0 <= swing < 1.0:
        raise ValueError("swing must be in [0, 1)")
    vals = [mean * (1.0 - swing * math.cos(2.0 * math.pi * i / samples
                                           + phase))
            for i in range(samples)]
    return TraceGrid(region=region, step_s=period_s / samples,
                     values=tuple(vals))
