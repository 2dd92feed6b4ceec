"""Embodied-carbon model (paper Eq. 1-2), ACT [Gupta+ ISCA'22] /
ECO-CHIP [Sudarshan+ HPCA'24] style.

    C_embodied = CFPA * A_die + CFPA_Si * A_wasted                      (1)
    CFPA       = (CI_fab * EPA + C_gas + C_material) / Y                (2)

with Murphy yield Y(A) = ((1 - e^{-A*D0}) / (A*D0))^2, 300 mm wafers and the
standard dies-per-wafer edge-loss formula.  Constants are public-ballpark
values (ACT's fab model); the paper's claims are *relative* (percent carbon
reduction), which depend on area ratios, not on the absolute CFPA scale.
See README "Carbon model & co-design" for the per-constant sources.

CDP (Carbon-Delay-Product) = C_embodied * delay, delay = 1/FPS.

Two call surfaces share the same constants:

  * scalar Python functions (`murphy_yield`, `cfpa`, `embodied_carbon`,
    `cdp`) — the numpy GA reference twin and the report printers;
  * batched tensor functions (`murphy_yield_arr`, `cfpa_arr`,
    `embodied_carbon_g_arr`, `cdp_arr`) — pure elementwise maps over whole
    GA populations in float32 on the population's device, inside the
    batched GA step (`core/ga_batched.py`).

Every function takes an optional `ci_fab` override (fab grid carbon
intensity, g CO2/kWh) so scenario sweeps can model hydro-backed vs
coal-backed fabs without mutating module state.
"""

from __future__ import annotations

import dataclasses
import math

import torch

# --- per-technology-node fab parameters -------------------------------------
# EPA:   manufacturing energy per unit area [kWh / cm^2].  ACT [Gupta+
#        ISCA'22] Fig. 4 fab-energy trend (older nodes: imec/TSMC
#        sustainability-report ballpark); rises toward advanced nodes with
#        the EUV layer count.
# C_gas: direct greenhouse-gas emissions from processing [g CO2 / cm^2]
#        (PFC/NF3 etch+clean chemistry; ACT's "gas" term, scaled per cm^2).
# D0:    defect density [defects / cm^2]; public foundry-ballpark maturity
#        figures, feeding the Murphy yield model (ECO-CHIP uses the same
#        yield treatment for chiplet vs monolithic carbon).
# freq:  nominal accelerator clock at that node [Hz] (DVFS-free edge-SoC
#        operating point; sets the dataflow model's cycle time).
NODE_PARAMS: dict[int, dict[str, float]] = {
    7:  {"EPA": 2.15, "C_gas": 280.0, "D0": 0.20, "freq": 1.4e9},
    14: {"EPA": 1.20, "C_gas": 200.0, "D0": 0.10, "freq": 1.0e9},
    28: {"EPA": 0.85, "C_gas": 150.0, "D0": 0.05, "freq": 0.7e9},
}

# Fab electricity carbon intensity [g CO2/kWh].  ACT's default fab mix
# (Taiwan/Korea grid-dominated, ~0.6 kg/kWh); scenario sweeps override this
# via the `ci_fab` argument (e.g. ~50 hydro/nuclear-backed, ~820 coal grid).
CI_FAB_G_PER_KWH = 620.0
# Raw material procurement [g CO2 / cm^2]: ACT's per-area materials term
# (wafer + chemicals + gases procurement upstream of the fab).
C_MATERIAL_G_PER_CM2 = 500.0
# Raw silicon wafer processing [g CO2 / cm^2], charged to *wasted* wafer
# area in Eq. 1 (edge dies + sawing loss carry silicon cost but no
# patterning cost) — the ECO-CHIP A_wasted treatment.
CFPA_SI_G_PER_CM2 = 130.0
WAFER_DIAMETER_MM = 300.0

# --- multi-die packaging (ECO-CHIP-style chiplet integration) ----------------
# Splitting one accelerator across N dies buys per-die Murphy yield (small
# dies) and an extra DRAM channel per die, but pays a packaging term:
# an interposer/RDL substrate sized to the summed die area plus spacing,
# charged at the raw-silicon rate (it is patterned coarsely, not at the
# logic node), and a per-die bonding/assembly energy share.
PACKAGING_AREA_OVERHEAD = 0.10      # interposer area beyond summed die area
C_BONDING_G_PER_DIE = 8.0           # die-attach / D2D bonding per die [g]


def murphy_yield(area_mm2: float, node_nm: int) -> float:
    """Murphy's yield model; area in mm^2, D0 in defects/cm^2."""
    d0 = NODE_PARAMS[node_nm]["D0"]
    ad = (area_mm2 / 100.0) * d0
    if ad < 1e-9:
        return 1.0
    return ((1.0 - math.exp(-ad)) / ad) ** 2


def dies_per_wafer(area_mm2: float) -> float:
    """Gross dies per 300 mm wafer (standard edge-loss approximation)."""
    d = WAFER_DIAMETER_MM
    side = math.sqrt(max(area_mm2, 1e-9))
    return max(1.0, math.pi * (d / 2.0) ** 2 / area_mm2
               - math.pi * d / (math.sqrt(2.0) * side))


@dataclasses.dataclass(frozen=True)
class CarbonBreakdown:
    die_g: float          # CFPA * A_die
    wasted_g: float       # CFPA_Si * A_wasted
    total_g: float
    cfpa_g_per_cm2: float
    yield_: float
    area_mm2: float
    node_nm: int

    @property
    def total_kg(self) -> float:
        return self.total_g / 1000.0


def cfpa(node_nm: int, area_mm2: float,
         ci_fab: float | None = None) -> tuple[float, float]:
    """Eq. 2: carbon footprint per cm^2 of *die* area; returns (CFPA, Y)."""
    p = NODE_PARAMS[node_nm]
    ci = CI_FAB_G_PER_KWH if ci_fab is None else ci_fab
    y = murphy_yield(area_mm2, node_nm)
    val = (ci * p["EPA"] + p["C_gas"] + C_MATERIAL_G_PER_CM2) / y
    return val, y


def embodied_carbon(area_mm2: float, node_nm: int,
                    ci_fab: float | None = None) -> CarbonBreakdown:
    """Eq. 1 for a monolithic accelerator die."""
    cfpa_val, y = cfpa(node_nm, area_mm2, ci_fab)
    area_cm2 = area_mm2 / 100.0
    dpw = dies_per_wafer(area_mm2)
    wafer_area_cm2 = math.pi * (WAFER_DIAMETER_MM / 20.0) ** 2
    wasted_cm2_per_die = max(0.0, wafer_area_cm2 / dpw - area_cm2)
    die_g = cfpa_val * area_cm2
    wasted_g = CFPA_SI_G_PER_CM2 * wasted_cm2_per_die
    return CarbonBreakdown(
        die_g=die_g, wasted_g=wasted_g, total_g=die_g + wasted_g,
        cfpa_g_per_cm2=cfpa_val, yield_=y, area_mm2=area_mm2, node_nm=node_nm)


def cdp(carbon_g: float, fps: float) -> float:
    """Carbon-Delay-Product [g CO2 * s]; lower is better."""
    return carbon_g / max(fps, 1e-9)


# ---------------------------------------------------------------------------
# Multi-die packages: per-die Murphy yield + packaging overhead.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MultiDieBreakdown:
    """Embodied carbon of an `n_dies`-die package (Eq. 1 per die + the
    ECO-CHIP packaging term).  `n_dies == 1` collapses exactly to the
    monolithic `embodied_carbon` (zero packaging)."""
    per_die: CarbonBreakdown   # one die at `die_area_mm2`
    n_dies: int
    packaging_g: float
    total_g: float

    @property
    def die_area_mm2(self) -> float:
        return self.per_die.area_mm2

    @property
    def die_yield(self) -> float:
        return self.per_die.yield_

    @property
    def total_area_mm2(self) -> float:
        """Total patterned silicon (excl. interposer)."""
        return self.n_dies * self.per_die.area_mm2


def packaging_carbon(die_area_mm2: float, n_dies: int) -> float:
    """Packaging/bonding carbon [g] for an `n_dies` package; 0 for a
    monolithic die (no interposer, no D2D bonding)."""
    if n_dies <= 1:
        return 0.0
    interposer_cm2 = n_dies * (die_area_mm2 / 100.0) * \
        (1.0 + PACKAGING_AREA_OVERHEAD)
    return CFPA_SI_G_PER_CM2 * interposer_cm2 + C_BONDING_G_PER_DIE * n_dies


def multi_die_carbon(die_area_mm2: float, n_dies: int, node_nm: int,
                     ci_fab: float | None = None) -> MultiDieBreakdown:
    """Embodied carbon of `n_dies` identical dies of `die_area_mm2` each,
    plus packaging.  The per-die Murphy yield is evaluated at the DIE area,
    which is the whole point: N small dies out-yield one N-times-larger
    die superlinearly (the chiplet lever of ECO-CHIP / the paper's Eq. 2
    denominator)."""
    per_die = embodied_carbon(die_area_mm2, node_nm, ci_fab)
    pkg = packaging_carbon(die_area_mm2, n_dies)
    return MultiDieBreakdown(
        per_die=per_die, n_dies=n_dies, packaging_g=pkg,
        total_g=n_dies * per_die.total_g + pkg)


def node_frequency(node_nm: int) -> float:
    return NODE_PARAMS[node_nm]["freq"]


# ---------------------------------------------------------------------------
# Batched tensor forms — same equations over whole populations.
# ---------------------------------------------------------------------------

def murphy_yield_arr(area_mm2: torch.Tensor, d0: float) -> torch.Tensor:
    ad = (area_mm2 / 100.0) * d0
    safe = torch.clamp(ad, min=1e-9)
    # -expm1(-x) == 1 - e^{-x} without the f32 cancellation at small x
    y = (-torch.expm1(-safe) / safe) ** 2
    return torch.where(ad < 1e-9, 1.0, y)


def cfpa_arr(area_mm2: torch.Tensor, node_nm: int,
             ci_fab: float | torch.Tensor | None = None) -> torch.Tensor:
    p = NODE_PARAMS[node_nm]
    ci = CI_FAB_G_PER_KWH if ci_fab is None else ci_fab
    y = murphy_yield_arr(area_mm2, p["D0"])
    return (ci * p["EPA"] + p["C_gas"] + C_MATERIAL_G_PER_CM2) / y


def embodied_carbon_g_arr(area_mm2: torch.Tensor, node_nm: int,
                          ci_fab: float | torch.Tensor | None = None
                          ) -> torch.Tensor:
    """Eq. 1 total grams for a tensor of die areas (population-parallel).

    The wasted-area term is algebraically restructured: with
    dpw = wafer/area - edge (unclamped), `wafer/dpw - area` equals
    `area * edge / dpw` exactly — the product form avoids the f32
    catastrophic cancellation of subtracting two nearly equal quotients
    for small dies."""
    cfpa_val = cfpa_arr(area_mm2, node_nm, ci_fab)
    area_cm2 = area_mm2 / 100.0
    d = WAFER_DIAMETER_MM
    wafer_area_cm2 = math.pi * (d / 20.0) ** 2
    side = torch.sqrt(torch.clamp(area_mm2, min=1e-9))
    edge = math.pi * d / (math.sqrt(2.0) * side)
    dpw_raw = math.pi * (d / 2.0) ** 2 / area_mm2 - edge
    wasted = torch.where(dpw_raw >= 1.0,
                         area_cm2 * edge / torch.clamp(dpw_raw, min=1.0),
                         wafer_area_cm2 - area_cm2)
    wasted = torch.clamp(wasted, min=0.0)
    return cfpa_val * area_cm2 + CFPA_SI_G_PER_CM2 * wasted


def cdp_arr(carbon_g: torch.Tensor, fps: torch.Tensor) -> torch.Tensor:
    return carbon_g / torch.clamp(fps, min=1e-9)


def packaging_carbon_arr(die_area_mm2: torch.Tensor, n_dies: torch.Tensor
                         ) -> torch.Tensor:
    """`packaging_carbon` over tensors (n_dies may be float-valued)."""
    interposer_cm2 = n_dies * (die_area_mm2 / 100.0) * \
        (1.0 + PACKAGING_AREA_OVERHEAD)
    pkg = CFPA_SI_G_PER_CM2 * interposer_cm2 + C_BONDING_G_PER_DIE * n_dies
    return torch.where(n_dies > 1, pkg, 0.0)


def multi_die_carbon_g_arr(die_area_mm2: torch.Tensor, n_dies: torch.Tensor,
                           node_nm: int,
                           ci_fab: float | torch.Tensor | None = None
                           ) -> torch.Tensor:
    """`multi_die_carbon(...).total_g` as a pure tensor function (the
    population-parallel form used inside the batched GA step)."""
    per_die = embodied_carbon_g_arr(die_area_mm2, node_nm, ci_fab)
    return n_dies * per_die + packaging_carbon_arr(die_area_mm2, n_dies)
