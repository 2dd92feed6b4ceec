"""Genetic algorithm over (accelerator config x approximate multiplier) with
Carbon-Delay-Product fitness under FPS and accuracy-drop constraints.

This is the paper's step 2: "a genetic algorithm, with CDP metric as fitness
function, to select the Pareto-optimal approximate multipliers from step one
and identify the most efficient topology ... constrained by thresholds for
accuracy drop and performance".
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np

from . import accelerator as accmod
from . import carbon as carbonmod
from . import dataflow as dfmod
from . import multipliers as mm

# --- accuracy-drop model -----------------------------------------------------
# Default proxy mapping multiplier error statistics -> top-1 accuracy drop
# (percent) for int8-quantized CNNs.  Coefficients calibrated against the
# framework's own ApproxTrain-style evaluation (`launch/codesign.py` trains
# a small CNN, measures real drops and refits these two numbers).  The GA
# accepts any callable so the calibrated evaluator can be plugged in.

ACC_DROP_NMED_COEF = 55.0   # %drop per unit NMED
ACC_DROP_MRED_COEF = 4.0    # %drop per unit MRED


def proxy_accuracy_drop(mult: mm.ApproxMultiplier) -> float:
    return (ACC_DROP_NMED_COEF * mult.stats.nmed
            + ACC_DROP_MRED_COEF * mult.stats.mred) * 1.0


AccuracyFn = Callable[[mm.ApproxMultiplier], float]

# --- design space ------------------------------------------------------------

RF_CHOICES = (32, 64, 128)
GLB_KIB_CHOICES = (64, 128, 256, 512, 1024)
ASPECTS = ("square", "wide", "tall")
#: Dies per package: the genome's partitioning gene.  >1 splits the PE
#: array's output-channel columns across identical dies (per-die Murphy
#: yield + one DRAM channel per die, at a packaging-carbon and D2D-delay
#: cost — core/carbon.py, core/dataflow.py).
DIE_CHOICES = (1, 2, 4)


def _pe_split(num_pes: int, aspect: str) -> tuple[int, int]:
    rows = 1
    while rows * rows < num_pes:
        rows *= 2
    cols = num_pes // rows
    if aspect == "wide":
        rows, cols = max(rows // 2, 1), cols * 2
    elif aspect == "tall":
        rows, cols = rows * 2, max(cols // 2, 1)
    return rows, cols


def die_feasible(pe_cols: int, num_pes: int, n_dies: int) -> bool:
    """An n-die split must cut the output-channel columns evenly and leave
    each die a full design-space array (>= smallest VALID_PE_COUNTS)."""
    return (n_dies == 1 or
            (pe_cols % n_dies == 0 and
             num_pes // n_dies >= accmod.VALID_PE_COUNTS[0]))


@dataclasses.dataclass(frozen=True)
class Genome:
    pe_idx: int
    aspect_idx: int
    rf_idx: int
    glb_idx: int
    mult_idx: int
    die_idx: int = 0

    @property
    def n_dies(self) -> int:
        return DIE_CHOICES[self.die_idx]

    def to_config(self, mults: Sequence[mm.ApproxMultiplier], node_nm: int
                  ) -> accmod.AcceleratorConfig:
        """FULL-array config (all dies cooperating); `glb_kib` is per-die."""
        pes = accmod.VALID_PE_COUNTS[self.pe_idx]
        rows, cols = _pe_split(pes, ASPECTS[self.aspect_idx])
        return accmod.AcceleratorConfig(
            pe_rows=rows, pe_cols=cols,
            rf_bytes_per_pe=RF_CHOICES[self.rf_idx],
            glb_kib=GLB_KIB_CHOICES[self.glb_idx],
            multiplier=mults[self.mult_idx].name,
            node_nm=node_nm)

    def to_target(self, mults: Sequence[mm.ApproxMultiplier], node_nm: int):
        """Decode into a `HardwareTarget` (per-die config + serving mesh
        with the model axis = die count)."""
        from . import target as targetmod
        full = self.to_config(mults, node_nm)
        n = self.n_dies
        if not die_feasible(full.pe_cols, full.num_pes, n):
            raise ValueError(f"genome {self} is not an even die split")
        die = dataclasses.replace(full, pe_cols=full.pe_cols // n)
        return targetmod.HardwareTarget(
            die=die, n_dies=n, mesh_axes=(("data", 1), ("model", n)))


@dataclasses.dataclass
class GAConfig:
    pop_size: int = 24
    generations: int = 14
    tournament: int = 3
    p_crossover: float = 0.7
    p_mutate_gene: float = 0.25
    seed: int = 0
    fps_penalty: float = 50.0


@dataclasses.dataclass(frozen=True)
class Evaluated:
    genome: Genome
    config: accmod.AcceleratorConfig   # full array; glb_kib is per-die
    fps: float
    carbon_g: float                    # package total (dies + packaging)
    cdp: float
    fitness: float
    area_mm2: float                    # total patterned silicon, all dies
    n_dies: int = 1
    die_area_mm2: float = 0.0
    die_yield: float = 1.0
    packaging_g: float = 0.0


@dataclasses.dataclass
class GAResult:
    best: Evaluated
    history: list[float]            # best fitness per generation
    population: list[Evaluated]
    mults: list[mm.ApproxMultiplier]


def _register(mults: Sequence[mm.ApproxMultiplier]) -> None:
    """Make GA multipliers resolvable by name for the area model."""
    lib = mm.static_library()
    for m in mults:
        lib.setdefault(m.name, m)


def evaluate(genome: Genome, workload: str, node_nm: int,
             mults: Sequence[mm.ApproxMultiplier], fps_min: float,
             cfg: GAConfig, ci_fab: float | None = None) -> Evaluated:
    acfg = genome.to_config(mults, node_nm)
    n_dies = genome.n_dies
    perf = dfmod.workload_perf(workload, acfg, n_dies)
    die_area = accmod.die_area_mm2(acfg, n_dies)
    cb = carbonmod.multi_die_carbon(die_area, n_dies, node_nm, ci_fab)
    cdp = carbonmod.cdp(cb.total_g, perf.fps)
    # Fitness uses fps CAPPED at the threshold: the paper's premise is that
    # edge applications need fps_min and nothing more ("accelerators are
    # often overdesigned, providing more performance than necessary") — so
    # speed beyond the requirement must not buy carbon headroom.
    eff_fps = min(perf.fps, fps_min) if fps_min > 0 else perf.fps
    fitness = carbonmod.cdp(cb.total_g, eff_fps)
    if perf.fps < fps_min:
        deficit = (fps_min - perf.fps) / fps_min
        fitness = fitness * (1.0 + cfg.fps_penalty * deficit *
                             (1.0 + deficit))
    # uneven die splits never score (mirrors the batched engine's
    # die-feasibility mask); metrics stay reportable for parity checks
    if not die_feasible(acfg.pe_cols, acfg.num_pes, n_dies):
        fitness = float("inf")
    return Evaluated(genome, acfg, perf.fps, cb.total_g, cdp, fitness,
                     n_dies * die_area, n_dies=n_dies,
                     die_area_mm2=die_area, die_yield=cb.die_yield,
                     packaging_g=cb.packaging_g)


def run_ga(workload: str, node_nm: int, fps_min: float,
           max_accuracy_drop: float,
           mults: Sequence[mm.ApproxMultiplier] | None = None,
           accuracy_fn: AccuracyFn = proxy_accuracy_drop,
           cfg: GAConfig | None = None,
           ci_fab: float | None = None) -> GAResult:
    """CDP-minimizing GA.  Multipliers violating the accuracy constraint are
    excluded up front (constraint satisfaction by construction).

    This sequential numpy loop is the PARITY REFERENCE TWIN of the
    population-parallel engine in `core/ga_batched.py`: both must select
    the same best-CDP design at a fixed seed."""
    cfg = cfg or GAConfig()
    rng = np.random.default_rng(cfg.seed)
    if mults is None:
        from . import pareto
        mults = pareto.default_front()
    allowed = [m for m in mults if accuracy_fn(m) <= max_accuracy_drop]
    if not any(m.is_exact for m in allowed):
        allowed = [mm.exact_multiplier()] + list(allowed)
    _register(allowed)

    n_pe = len(accmod.VALID_PE_COUNTS)

    def random_genome() -> Genome:
        return Genome(
            int(rng.integers(0, n_pe)), int(rng.integers(0, len(ASPECTS))),
            int(rng.integers(0, len(RF_CHOICES))),
            int(rng.integers(0, len(GLB_KIB_CHOICES))),
            int(rng.integers(0, len(allowed))),
            int(rng.integers(0, len(DIE_CHOICES))))

    def ev(g: Genome) -> Evaluated:
        return evaluate(g, workload, node_nm, allowed, fps_min, cfg, ci_fab)

    pop = [ev(random_genome()) for _ in range(cfg.pop_size)]
    history: list[float] = []
    genes = ("pe_idx", "aspect_idx", "rf_idx", "glb_idx", "mult_idx",
             "die_idx")
    ranges = (n_pe, len(ASPECTS), len(RF_CHOICES), len(GLB_KIB_CHOICES),
              len(allowed), len(DIE_CHOICES))

    for _gen in range(cfg.generations):
        pop.sort(key=lambda e: e.fitness)
        history.append(pop[0].fitness)
        next_pop = pop[:2]  # elitism
        while len(next_pop) < cfg.pop_size:
            def pick() -> Evaluated:
                idx = rng.integers(0, len(pop), size=cfg.tournament)
                return min((pop[i] for i in idx), key=lambda e: e.fitness)
            p1, p2 = pick(), pick()
            vals = {}
            for gname in genes:
                src = p1 if (rng.random() < 0.5 or
                             rng.random() >= cfg.p_crossover) else p2
                vals[gname] = getattr(src.genome, gname)
            for gname, rng_n in zip(genes, ranges):
                if rng.random() < cfg.p_mutate_gene:
                    vals[gname] = int(rng.integers(0, rng_n))
            next_pop.append(ev(Genome(**vals)))
        pop = next_pop

    pop.sort(key=lambda e: e.fitness)
    history.append(pop[0].fitness)
    return GAResult(best=pop[0], history=history, population=pop,
                    mults=list(allowed))


def exact_baseline(workload: str, node_nm: int, fps_min: float,
                   ci_fab: float | None = None) -> Evaluated:
    """Smallest-carbon *exact* NVDLA-default config meeting the FPS bound
    (the paper's 'exact baseline meeting a 30 FPS threshold')."""
    best: Evaluated | None = None
    for pe_idx in range(len(accmod.VALID_PE_COUNTS)):
        # NVDLA default buffers for this PE count (the genome record is
        # descriptive only — the config does not come from genome decode,
        # so no GA evaluate() call belongs here):
        acfg = accmod.nvdla_default(accmod.VALID_PE_COUNTS[pe_idx], node_nm)
        perf = dfmod.workload_perf(workload, acfg)
        area = accmod.area_model(acfg)
        cb = carbonmod.embodied_carbon(area.total_mm2, node_nm, ci_fab)
        e = Evaluated(Genome(pe_idx, 0, 0, 2, 0), acfg, perf.fps, cb.total_g,
                      carbonmod.cdp(cb.total_g, perf.fps),
                      carbonmod.cdp(cb.total_g, perf.fps), area.total_mm2)
        if perf.fps >= fps_min and (best is None or e.carbon_g < best.carbon_g):
            best = e
    if best is None:  # nothing meets the bound: return the fastest
        acfg = accmod.nvdla_default(accmod.VALID_PE_COUNTS[-1], node_nm)
        perf = dfmod.workload_perf(workload, acfg)
        area = accmod.area_model(acfg)
        cb = carbonmod.embodied_carbon(area.total_mm2, node_nm, ci_fab)
        best = Evaluated(Genome(len(accmod.VALID_PE_COUNTS) - 1, 0, 0, 2, 0),
                         acfg, perf.fps, cb.total_g,
                         carbonmod.cdp(cb.total_g, perf.fps),
                         carbonmod.cdp(cb.total_g, perf.fps), area.total_mm2)
    return best


def approx_variant(base: accmod.AcceleratorConfig, mult: mm.ApproxMultiplier
                   ) -> Evaluated:
    """Same architecture, approximate multiplier swapped in (paper's
    'incorporating approximate units only, keeping the architecture
    unchanged')."""
    _register([mult])
    acfg = dataclasses.replace(base, multiplier=mult.name)
    # workload-independent carbon; FPS unchanged (same array/freq)
    area = accmod.area_model(acfg)
    cb = carbonmod.embodied_carbon(area.total_mm2, acfg.node_nm)
    return Evaluated(Genome(0, 0, 0, 0, 0), acfg, float("nan"), cb.total_g,
                     float("nan"), float("nan"), area.total_mm2)
