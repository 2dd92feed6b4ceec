"""End-to-end co-design methodology (paper Fig. 1).

  step 1: generate area-aware approximate multipliers (NSGA-II Pareto front),
  step 2: GA over accelerator configs + mappings + multiplier choice with CDP
          fitness under FPS / accuracy-drop constraints,
  report: exact baseline, approx-only variant, GA-CDP design -- the three
          bars of the paper's Fig. 3 (and the points of Fig. 2).

Beyond the single-point reproduction, `scenario_grid` / `run_scenarios`
sweep the co-design over (technology node x fab grid carbon intensity x
workload — CNN frames and LM serving traces alike) with the
population-parallel engine (`core/ga_batched.py`), optionally reporting
serving-calibrated CDP next to the analytical figure
(`core/calibrate.py`).  The population-parallel paths run on an
explicit device: the CUDA device unless the caller passes `device="cpu"`;
the numpy engine needs none.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from . import accelerator as accmod
from . import calibrate as calmod
from . import carbon as carbonmod
from . import dataflow as dfmod
from . import ga as gamod
from . import multipliers as mm
from . import pareto as paretomod


@dataclasses.dataclass(frozen=True)
class CodesignReport:
    workload: str
    node_nm: int
    fps_min: float
    max_accuracy_drop: float
    exact: gamod.Evaluated
    approx_only: gamod.Evaluated
    ga_cdp: gamod.Evaluated
    approx_only_reduction: float   # carbon vs exact, same architecture
    ga_reduction: float            # carbon vs exact baseline

    def summary(self) -> str:
        return (
            f"[{self.workload} @ {self.node_nm}nm, fps>={self.fps_min:.0f}, "
            f"drop<={self.max_accuracy_drop:.1f}%]\n"
            f"  exact     : {self.exact.config.num_pes:5d} PEs "
            f"{self.exact.area_mm2:7.3f} mm2  {self.exact.carbon_g:8.2f} g  "
            f"{self.exact.fps:6.1f} fps\n"
            f"  approx    : {self.approx_only.config.num_pes:5d} PEs "
            f"{self.approx_only.area_mm2:7.3f} mm2  "
            f"{self.approx_only.carbon_g:8.2f} g  (mult="
            f"{self.approx_only.config.multiplier})  "
            f"carbon -{100 * self.approx_only_reduction:.2f}%\n"
            f"  GA-CDP    : {self.ga_cdp.config.num_pes:5d} PEs "
            f"{self.ga_cdp.area_mm2:7.3f} mm2  {self.ga_cdp.carbon_g:8.2f} g  "
            f"{self.ga_cdp.fps:6.1f} fps  (mult={self.ga_cdp.config.multiplier})"
            f"  carbon -{100 * self.ga_reduction:.2f}%"
        )


def run_codesign(workload: str, node_nm: int, fps_min: float,
                 max_accuracy_drop: float,
                 mults: list[mm.ApproxMultiplier] | None = None,
                 accuracy_fn: gamod.AccuracyFn = gamod.proxy_accuracy_drop,
                 ga_cfg: gamod.GAConfig | None = None,
                 engine: str = "numpy",
                 batched_cfg=None,
                 device: str | torch.device | None = None) -> CodesignReport:
    """`engine="numpy"` runs the sequential reference GA; `"batched"` the
    population-parallel engine (`core/ga_batched.py`, configured by
    `batched_cfg`, on `device`) — both report through the same reference
    evaluator."""
    if mults is None:
        mults = paretomod.default_front() + list(mm.static_library().values())

    exact = gamod.exact_baseline(workload, node_nm, fps_min)

    # approx-only: same architecture, best multiplier within the drop budget
    allowed = [m for m in mults if accuracy_fn(m) <= max_accuracy_drop
               and not m.is_exact]
    if allowed:
        best_mult = min(allowed, key=lambda m: m.area_nand2eq)
        approx_only = gamod.approx_variant(exact.config, best_mult)
    else:
        approx_only = exact

    if engine == "batched":
        from . import ga_batched as gbmod
        result = gbmod.run_ga_batched(
            workload, node_nm, fps_min, max_accuracy_drop, mults=mults,
            accuracy_fn=accuracy_fn, cfg=batched_cfg, device=device)
    elif engine == "numpy":
        result = gamod.run_ga(workload, node_nm, fps_min, max_accuracy_drop,
                              mults=mults, accuracy_fn=accuracy_fn,
                              cfg=ga_cfg)
    else:
        raise ValueError(f"unknown engine {engine!r}")
    ga_best = result.best

    return CodesignReport(
        workload=workload, node_nm=node_nm, fps_min=fps_min,
        max_accuracy_drop=max_accuracy_drop,
        exact=exact, approx_only=approx_only, ga_cdp=ga_best,
        approx_only_reduction=1.0 - approx_only.carbon_g / exact.carbon_g,
        ga_reduction=1.0 - ga_best.carbon_g / exact.carbon_g,
    )


def sweep_exact_configs(workload: str, node_nm: int
                        ) -> list[gamod.Evaluated]:
    """The paper's Fig. 2 baseline curve: exact NVDLA configs 64..2048 PEs."""
    out = []
    for pes in accmod.VALID_PE_COUNTS:
        acfg = accmod.nvdla_default(pes, node_nm)
        perf = dfmod.workload_perf(workload, acfg)
        area = accmod.area_model(acfg)
        cb = carbonmod.embodied_carbon(area.total_mm2, node_nm)
        out.append(gamod.Evaluated(
            gamod.Genome(0, 0, 0, 0, 0), acfg, perf.fps, cb.total_g,
            carbonmod.cdp(cb.total_g, perf.fps),
            carbonmod.cdp(cb.total_g, perf.fps), area.total_mm2))
    return out


def approx_only_sweep(workload: str, node_nm: int, max_drop: float,
                      mults: list[mm.ApproxMultiplier],
                      accuracy_fn: gamod.AccuracyFn = gamod.proxy_accuracy_drop
                      ) -> list[gamod.Evaluated]:
    """Fig. 2 'Appx' curves: every exact config with the best multiplier
    within the accuracy budget swapped in."""
    allowed = [m for m in mults if accuracy_fn(m) <= max_drop
               and not m.is_exact]
    if not allowed:
        return sweep_exact_configs(workload, node_nm)
    best_mult = min(allowed, key=lambda m: m.area_nand2eq)
    out = []
    for e in sweep_exact_configs(workload, node_nm):
        out.append(gamod.approx_variant(e.config, best_mult))
    return out


# ---------------------------------------------------------------------------
# Scenario sweeps over (node x fab carbon intensity x workload) with the
# population-parallel engine.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Scenario:
    workload: str
    node_nm: int
    ci_fab: float = carbonmod.CI_FAB_G_PER_KWH  # fab grid [g CO2/kWh]
    fps_min: float = 30.0
    max_accuracy_drop: float = 2.0

    @property
    def name(self) -> str:
        return (f"{self.workload}@{self.node_nm}nm"
                f"/ci{self.ci_fab:.0f}/fps{self.fps_min:.0f}")


def scenario_grid(workloads: tuple[str, ...] = ("vgg16", "resnet50",
                                                "tiny_lm", "lm_serving"),
                  nodes: tuple[int, ...] = (7, 14, 28),
                  ci_fabs: tuple[float, ...] = (
                      50.0,                          # hydro/nuclear fab
                      carbonmod.CI_FAB_G_PER_KWH,    # ACT default mix
                      820.0),                        # coal-heavy grid
                  fps_min: float = 30.0,
                  max_accuracy_drop: float = 2.0) -> list[Scenario]:
    return [Scenario(w, n, ci, fps_min, max_accuracy_drop)
            for w in workloads for n in nodes for ci in ci_fabs]


def multi_die_scenarios(ci_fab: float = carbonmod.CI_FAB_G_PER_KWH,
                        max_accuracy_drop: float = 2.0) -> list[Scenario]:
    """Scenarios whose FPS floor sits ABOVE the monolithic design space's
    reach (one DRAM channel saturates) but within multi-die reach (one
    channel per die + inter-die all-gather): the partitioning gene has to
    fire for the GA to satisfy the application at all.  These are the
    points where `run_scenarios` records a >1-die winner next to the best
    monolithic design."""
    return [Scenario("vgg16", 7, ci_fab, 120.0, max_accuracy_drop),
            Scenario("vgg16", 14, ci_fab, 100.0, max_accuracy_drop),
            Scenario("resnet50", 7, ci_fab, 400.0, max_accuracy_drop)]


@dataclasses.dataclass(frozen=True)
class ScenarioResult:
    scenario: Scenario
    best: gamod.Evaluated
    exact: gamod.Evaluated
    ga_reduction: float            # carbon vs exact baseline
    cdp_calibrated: float | None   # CDP under measured (not modeled) delay
    wall_s: float
    mono: gamod.Evaluated | None = None   # best monolithic (die gene = 1)
    #: nondominated (carbon_g, delay_s) points of the final GA
    #: population (feasible designs only, <= _FRONTIER_MAX points) —
    #: the carbon/delay trade space behind the single CDP winner.
    frontier: list[dict] | None = None

    @staticmethod
    def _design_dict(e: gamod.Evaluated) -> dict:
        return {"num_pes": e.config.num_pes,
                "pe_rows": e.config.pe_rows,
                "pe_cols": e.config.pe_cols,
                "rf_bytes_per_pe": e.config.rf_bytes_per_pe,
                "glb_kib": e.config.glb_kib,
                "multiplier": e.config.multiplier,
                "area_mm2": e.area_mm2, "fps": e.fps,
                "carbon_g": e.carbon_g, "cdp": e.cdp,
                # the paper's fitness: CDP with fps capped at the floor
                # (+ superlinear penalty under it)
                "cdp_constrained": e.fitness,
                "n_dies": e.n_dies,
                "die_area_mm2": e.die_area_mm2,
                "die_yield": e.die_yield,
                "packaging_g": e.packaging_g}

    def to_dict(self) -> dict:
        sc = self.scenario
        return {
            "scenario": {"workload": sc.workload, "node_nm": sc.node_nm,
                         "ci_fab_g_per_kwh": sc.ci_fab,
                         "fps_min": sc.fps_min,
                         "max_accuracy_drop": sc.max_accuracy_drop},
            "best": self._design_dict(self.best),
            "best_monolithic": (self._design_dict(self.mono)
                                if self.mono is not None else None),
            "exact_baseline": {"num_pes": self.exact.config.num_pes,
                               "carbon_g": self.exact.carbon_g,
                               "fps": self.exact.fps,
                               "cdp": self.exact.cdp},
            "ga_reduction": self.ga_reduction,
            "cdp_calibrated": self.cdp_calibrated,
            "wall_s": self.wall_s,
            "frontier": self.frontier,
        }


_FRONTIER_MAX = 16


def population_frontier(metrics: dict, max_points: int = _FRONTIER_MAX
                        ) -> list[dict]:
    """(carbon_g, delay_s) nondominated front of a final GA population
    (`BatchedGAResult.metrics` arrays).  Feasible designs only; unique
    objective points; evenly thinned to `max_points`."""
    ok = (np.asarray(metrics["feasible"], bool)
          & np.isfinite(np.asarray(metrics["fitness"], float)))
    if not ok.any():
        return []
    carbon = np.asarray(metrics["carbon_g"], float)[ok]
    fps = np.asarray(metrics["fps"], float)[ok]
    pts = np.unique(np.stack(
        [carbon, 1.0 / np.maximum(fps, 1e-9)], axis=1), axis=0)
    idx = paretomod.nondominated_front(pts)
    if len(idx) > max_points:
        keep = np.unique(np.linspace(0, len(idx) - 1, max_points)
                         .round().astype(int))
        idx = idx[keep]
    return [{"carbon_g": float(pts[i, 0]), "delay_s": float(pts[i, 1]),
             "fps": float(1.0 / pts[i, 1]),
             "cdp": float(pts[i, 0] * pts[i, 1])} for i in idx]


def run_scenarios(scenarios: list[Scenario],
                  mults: list[mm.ApproxMultiplier] | None = None,
                  accuracy_fn: gamod.AccuracyFn = gamod.proxy_accuracy_drop,
                  cfg=None,
                  calibration: "calmod.DelayCalibration | None" = None,
                  device: str | torch.device | None = None
                  ) -> list[ScenarioResult]:
    """Population-parallel co-design across the scenario grid on `device`.
    One batched GA per scenario; the DesignSpace (FPS lattice +
    accuracy_fn evaluations — the expensive parts, and independent of
    ci_fab) is built once per (workload, node, constraints) and reused
    across the carbon-intensity axis."""
    from . import ga_batched as gbmod
    if mults is None:
        mults = paretomod.default_front() + list(mm.static_library().values())
    spaces: dict[tuple, "gbmod.DesignSpace"] = {}
    out = []
    for sc in scenarios:
        t0 = time.perf_counter()
        key = (sc.workload, sc.node_nm, sc.fps_min, sc.max_accuracy_drop)
        if key not in spaces:
            spaces[key] = gbmod.build_space(
                sc.workload, sc.node_nm, sc.fps_min, sc.max_accuracy_drop,
                mults=mults, accuracy_fn=accuracy_fn, device=device)
        space = dataclasses.replace(spaces[key], ci_fab=sc.ci_fab)
        res = gbmod.run_ga_batched(
            sc.workload, sc.node_nm, sc.fps_min, sc.max_accuracy_drop,
            cfg=cfg, space=space, device=device)
        exact = gamod.exact_baseline(sc.workload, sc.node_nm, sc.fps_min,
                                     ci_fab=sc.ci_fab)
        # best monolithic design (die gene pinned to 1) via exhaustive
        # search — the baseline that shows when partitioning is the win
        fps_pen = (cfg.fps_penalty if cfg is not None
                   else gbmod.BatchedGAConfig().fps_penalty)
        mono_genome, _ = gbmod.exhaustive_best(space, fps_pen, max_dies=1,
                                               device=device)
        mono = gamod.evaluate(mono_genome, sc.workload, sc.node_nm,
                              list(space.mults), sc.fps_min,
                              gamod.GAConfig(fps_penalty=fps_pen),
                              ci_fab=sc.ci_fab)
        cdp_cal = None
        if calibration is not None and calibration.source != "identity":
            cdp_cal = calibration.calibrated_cdp(res.best.carbon_g,
                                                 res.best.fps)
        out.append(ScenarioResult(
            scenario=sc, best=res.best, exact=exact,
            ga_reduction=1.0 - res.best.carbon_g / exact.carbon_g,
            cdp_calibrated=cdp_cal, wall_s=time.perf_counter() - t0,
            mono=mono, frontier=population_frontier(res.metrics)))
    return out


# ---------------------------------------------------------------------------
# Total-carbon axis: embodied + operational, closing the fleet loop.
# ---------------------------------------------------------------------------

def run_total_carbon(scenarios: list[Scenario], op,
                     mults: list[mm.ApproxMultiplier] | None = None,
                     accuracy_fn: gamod.AccuracyFn =
                     gamod.proxy_accuracy_drop,
                     fps_penalty: float = 50.0,
                     device: str | torch.device | None = None) -> list[dict]:
    """Per scenario: the CDP winner vs the **total-carbon** winner
    (amortized embodied + operational gCO2e per inference under `op`, a
    duck-typed operational-carbon model: scalar fields ci_use_g_per_kwh /
    lifetime_s / util / idle_frac / die_w / energy_scale plus
    `pe_active_w(node_nm)`), both by exhaustive search on `device` over
    the design space, so a differing winner is a property of the
    objectives — not GA noise.  The same objective is available to the
    batched GA via `BatchedGAConfig(objective="total_carbon")`; this
    reporting path uses ground truth.

    The winners genuinely diverge because CDP caps the fps credit at the
    floor (speed headroom is worthless) while the operational term's
    race-to-idle rewards real speed, and chiplet designs cut embodied
    carbon (yield) but pay die-to-die link energy every inference."""
    from . import ga_batched as gbmod
    if mults is None:
        mults = paretomod.default_front() + list(mm.static_library().values())
    spaces: dict[tuple, "gbmod.DesignSpace"] = {}
    out = []
    tc_keys = ("total_g_per_inf", "operational_g_per_inf",
               "embodied_g_per_inf", "energy_j_per_inf")

    def design(space, sc, genome, met):
        ev = gamod.evaluate(genome, sc.workload, sc.node_nm,
                            list(space.mults), sc.fps_min,
                            gamod.GAConfig(fps_penalty=fps_penalty),
                            ci_fab=sc.ci_fab)
        d = ScenarioResult._design_dict(ev)
        d.update({k: float(met[k]) for k in tc_keys})
        return d

    for sc in scenarios:
        key = (sc.workload, sc.node_nm, sc.fps_min, sc.max_accuracy_drop)
        if key not in spaces:
            spaces[key] = gbmod.build_space(
                sc.workload, sc.node_nm, sc.fps_min, sc.max_accuracy_drop,
                mults=mults, accuracy_fn=accuracy_fn, device=device)
        space = dataclasses.replace(spaces[key], ci_fab=sc.ci_fab, op=op)
        g_cdp, m_cdp = gbmod.exhaustive_best(space, fps_penalty,
                                             objective="cdp", device=device)
        g_tot, m_tot = gbmod.exhaustive_best(space, fps_penalty,
                                             objective="total_carbon",
                                             device=device)
        differs = (dataclasses.astuple(g_cdp) != dataclasses.astuple(g_tot))
        out.append({
            "scenario": {"workload": sc.workload, "node_nm": sc.node_nm,
                         "ci_fab_g_per_kwh": sc.ci_fab,
                         "fps_min": sc.fps_min,
                         "max_accuracy_drop": sc.max_accuracy_drop},
            "op": {"ci_use_g_per_kwh": op.ci_use_g_per_kwh,
                   "lifetime_s": op.lifetime_s, "util": op.util,
                   "idle_frac": op.idle_frac, "die_w": op.die_w,
                   "energy_scale": op.energy_scale},
            "cdp_winner": design(space, sc, g_cdp, m_cdp),
            "total_winner": design(space, sc, g_tot, m_tot),
            "differs": differs,
            # what pricing operational carbon saves vs shipping the CDP
            # design into this deployment
            "total_reduction": float(
                1.0 - m_tot["total_g_per_inf"]
                / max(m_cdp["total_g_per_inf"], 1e-30)),
        })
    return out
