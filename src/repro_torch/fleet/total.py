"""Total-carbon objective: embodied + operational per inference.

A fork of the JAX package's `fleet/total.py` (plain Python), held exactly
equal to it by `tests/test_torch_fleet.py`; the port's
`core/ga_batched.py` and `core/codesign.py` take its `OperationalModel`.

The paper's CDP metric prices only *embodied* carbon (fab footprint x
delay).  This module closes the loop the fleet opens: once serving is
metered (`fleet/meter.py`), a design's **operational** carbon per
inference is just as real as its fab carbon, and the two pull the search
in opposite directions — small approximate dies are cheap to build but
may run longer per inference; big exact dies amortize fab carbon over
more lifetime throughput but burn more Joules per token.

Per-inference model (scalar twin of the batched math inside
`core.ga_batched._metrics`; a parity test pins them together):

  fps_eff   = min(fps, fps_min)          duty-cycled at the requirement —
                                         speed headroom idles, it does
                                         not amortize more
  P_active  = pe_w(node) x num_pes x (0.5 + 0.5 x mult_escale)
                                         half the PE power rides the
                                         multiplier array, scaled by the
                                         approx multiplier's area ratio
            + die_w x (n_dies - 1)       die-to-die link power: chiplets
                                         buy fab yield (embodied) at the
                                         price of SerDes Joules — the
                                         axis where the two carbon terms
                                         pull in opposite directions
  P_idle    = idle_frac x P_active
  E_inf     = P_active / fps             race-to-idle active energy
            + P_idle x max(0, 1/fps_eff - 1/fps)
                                         idle tail while duty-cycling

  total_g   = embodied_g / (lifetime_s x util x fps_eff)   amortized fab
            + E_inf / 3.6e6 x ci_use                       operational

`OperationalModel` carries the deployment constants; `energy_scale` is
the measured-vs-modeled anchor (`EnergyCalibration`, same idiom as
`core/calibrate.py`'s delay anchor) so fleet meter readings ground the
analytic power model.

This module deliberately imports nothing from `core` — `core.ga_batched`
takes the model duck-typed (`op.pe_active_w(node_nm)` + scalar fields),
so the dependency stays one-way: fleet -> serving, core -> nothing new.
"""

from __future__ import annotations

import dataclasses

from repro_torch.fleet.meter import J_PER_KWH, PE_ACTIVE_W_BY_NODE

#: default device lifetime for embodied amortization (3 years, the
#: figure commonly used for accelerator LCA baselines).
LIFETIME_3Y_S = 3 * 365 * 24 * 3600.0


@dataclasses.dataclass(frozen=True)
class OperationalModel:
    """Deployment constants for the operational-carbon term.

    ci_use_g_per_kwh: grid intensity where the device runs (use-phase
      CI; contrast `carbon.CI_FAB_G_PER_KWH` for the fab).
    lifetime_s / util: amortization window — the device serves for
      `lifetime_s` at duty-cycle `util`.
    idle_frac: idle power as a fraction of active power.
    die_w: watts per *extra* die for die-to-die links (SerDes +
      PHY) — zero for monolithic designs.
    energy_scale: measured/modeled anchor (see `EnergyCalibration`);
      multiplies the per-PE power constants.
    """
    ci_use_g_per_kwh: float = 379.0          # us-east static default
    lifetime_s: float = LIFETIME_3Y_S
    util: float = 0.8
    idle_frac: float = 0.15
    die_w: float = 0.25
    energy_scale: float = 1.0

    def __post_init__(self):
        if self.ci_use_g_per_kwh < 0:
            raise ValueError("ci_use_g_per_kwh must be >= 0")
        if self.lifetime_s <= 0 or not 0 < self.util <= 1:
            raise ValueError("lifetime_s > 0 and 0 < util <= 1 required")
        if self.energy_scale <= 0:
            raise ValueError("energy_scale must be > 0")

    def pe_active_w(self, node_nm: int) -> float:
        """Active watts per PE at `node_nm` (duck-typed surface used by
        `core.ga_batched.DesignSpace.tables`)."""
        return PE_ACTIVE_W_BY_NODE[int(node_nm)] * self.energy_scale


def pe_power_w(num_pes: float, mult_escale: float, node_nm: int,
               op: OperationalModel, n_dies: float = 1.0) -> float:
    """Active power: half static/routing at full weight, half in the
    multiplier array scaled by its area ratio vs the exact design, plus
    die-to-die link power for chiplet designs."""
    return (op.pe_active_w(node_nm) * num_pes * (0.5 + 0.5 * mult_escale)
            + op.die_w * max(n_dies - 1.0, 0.0))


def energy_j_per_inf(fps: float, num_pes: float, mult_escale: float,
                     node_nm: int, op: OperationalModel,
                     fps_min: float = 0.0, n_dies: float = 1.0) -> float:
    """Race-to-idle energy per inference plus the duty-cycle idle tail."""
    if fps <= 0:
        raise ValueError("fps must be > 0")
    fps_eff = min(fps, fps_min) if fps_min > 0 else fps
    p_active = pe_power_w(num_pes, mult_escale, node_nm, op, n_dies)
    p_idle = op.idle_frac * p_active
    return p_active / fps + p_idle * max(0.0, 1.0 / fps_eff - 1.0 / fps)


def operational_g_per_inf(fps: float, num_pes: float, mult_escale: float,
                          node_nm: int, op: OperationalModel,
                          fps_min: float = 0.0,
                          n_dies: float = 1.0) -> float:
    return (energy_j_per_inf(fps, num_pes, mult_escale, node_nm, op,
                             fps_min, n_dies) / J_PER_KWH
            * op.ci_use_g_per_kwh)


def embodied_g_per_inf(embodied_g: float, fps: float,
                       op: OperationalModel,
                       fps_min: float = 0.0) -> float:
    """Fab carbon amortized over lifetime inferences at the duty-cycled
    rate: lifetime_s x util x min(fps, fps_min)."""
    fps_eff = min(fps, fps_min) if fps_min > 0 else fps
    return embodied_g / (op.lifetime_s * op.util * fps_eff)


def total_carbon_g_per_inf(embodied_g: float, fps: float, num_pes: float,
                           mult_escale: float, node_nm: int,
                           op: OperationalModel,
                           fps_min: float = 0.0,
                           n_dies: float = 1.0) -> float:
    """The full objective: amortized embodied + operational gCO2e per
    inference.  Scalar twin of the batched `total_g_per_inf` metric."""
    return (embodied_g_per_inf(embodied_g, fps, op, fps_min)
            + operational_g_per_inf(fps, num_pes, mult_escale, node_nm,
                                    op, fps_min, n_dies))


# ---------------------------------------------------------------------------
# Measured-energy anchoring (calibrate.py idiom)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EnergyCalibration:
    """Anchor the analytic power model to fleet meter readings.

    `scale` = measured / modeled Joules per token; `apply` folds it into
    an `OperationalModel`'s `energy_scale` so the GA's operational term
    is grounded in what the meter actually observed — the same
    measured-over-analytic pattern as `core.calibrate.DelayCalibration`.
    """
    measured_j_per_token: float
    modeled_j_per_token: float

    @property
    def scale(self) -> float:
        if self.modeled_j_per_token <= 0 or self.measured_j_per_token <= 0:
            return 1.0
        return self.measured_j_per_token / self.modeled_j_per_token

    def apply(self, op: OperationalModel) -> OperationalModel:
        return dataclasses.replace(
            op, energy_scale=op.energy_scale * self.scale)

    @classmethod
    def from_meter_summary(cls, summary: dict,
                           modeled_j_per_token: float
                           ) -> "EnergyCalibration":
        """Build from `EnergyMeter.summary()` (its per-token Joules are
        the measured side)."""
        return cls(measured_j_per_token=float(summary["energy_j_per_token"]),
                   modeled_j_per_token=float(modeled_j_per_token))


def modeled_j_per_token(num_pes: float, mult_escale: float, node_nm: int,
                        op: OperationalModel,
                        tokens_per_s: float) -> float:
    """Analytic J/token at a measured serving rate — the modeled side of
    `EnergyCalibration` when anchoring against a serving run."""
    if tokens_per_s <= 0:
        raise ValueError("tokens_per_s must be > 0")
    return pe_power_w(num_pes, mult_escale, node_nm, op) / tokens_per_s
