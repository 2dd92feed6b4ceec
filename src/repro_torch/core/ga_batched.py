"""Population-parallel co-design search: the paper's step-2 GA with the
whole population evaluated as one batched tensor program on the device.

`core/ga.py` (the numpy reference twin) evaluates genomes one Python call
at a time; this module keeps its design space, fitness definition, and
constraint semantics but turns them into struct-of-arrays compute:

  * genomes are an int64 (P, 6) tensor over
    (pe_idx, aspect_idx, rf_idx, glb_idx, mult_idx, die_idx);
  * FPS comes from a (n_pe, n_aspect, n_glb, n_die) lattice precomputed
    ONCE per (workload, node) by the batched dataflow model
    (`dataflow.batched_fps`), then the GA gathers from the lattice;
  * area / embodied carbon / CDP fitness are the float32 tensor functions
    `accelerator.area_total_mm2_arr` and `carbon.*_arr`;
  * tournament selection, uniform crossover, per-gene mutation, and
    constraint masking (accuracy-drop ceiling on the multiplier gene,
    FPS-floor penalty identical to the reference) run as whole-population
    tensor ops in one GA step (`_ga_step`) that syncs nothing to the host.

Everything runs on an explicit device: the CUDA device by default,
`device="cpu"` on request.  Random draws come from a `torch.Generator` on
that device seeded from the config, so a run repeats per (seed, device);
the draws are not JAX's threefry stream, so trajectories differ from the
JAX package's while the selected design agrees with the numpy twin and
with `exhaustive_best`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device

from . import accelerator as accmod
from . import carbon as carbonmod
from . import dataflow as dfmod
from . import ga as gamod
from . import multipliers as mm

GENE_NAMES = ("pe_idx", "aspect_idx", "rf_idx", "glb_idx", "mult_idx",
              "die_idx")
N_GENES = len(GENE_NAMES)
MULT_GENE = GENE_NAMES.index("mult_idx")
DIE_GENE = GENE_NAMES.index("die_idx")


@dataclasses.dataclass
class BatchedGAConfig:
    pop_size: int = 4096
    generations: int = 12
    tournament: int = 3
    p_crossover: float = 0.7
    p_mutate_gene: float = 0.25
    seed: int = 0
    fps_penalty: float = 50.0
    elitism: int = 2
    #: "cdp" (the paper's embodied-carbon-x-delay fitness) or
    #: "total_carbon" (amortized embodied + operational gCO2e per
    #: inference; requires `DesignSpace.op`).
    objective: str = "cdp"


@dataclasses.dataclass(frozen=True)
class DesignSpace:
    """Host-side index->physical-quantity tables for one (workload, node,
    constraint) instance.  `tables(device)` repackages them as float32
    tensors on the device for the batched step."""
    workload: str
    node_nm: int
    fps_min: float
    max_accuracy_drop: float
    ci_fab: float | None
    mults: tuple[mm.ApproxMultiplier, ...]
    rows: np.ndarray          # (n_pe, n_aspect) physical PE rows
    cols: np.ndarray          # (n_pe, n_aspect)
    num_pes: np.ndarray       # (n_pe,)
    rf_bytes: np.ndarray      # (n_rf,)
    glb_kib: np.ndarray       # (n_glb,)
    mult_area: np.ndarray     # (n_mults,) NAND2-equivalents
    mult_allowed: np.ndarray  # (n_mults,) bool — accuracy-drop ceiling
    fps_table: np.ndarray     # (n_pe, n_aspect, n_glb, n_die)
    exact_idx: int            # fallback gene for constraint masking
    dies: np.ndarray          # (n_die,) die counts (gamod.DIE_CHOICES)
    die_ok: np.ndarray        # (n_pe, n_aspect, n_die) bool — even splits
    #: operational-carbon model for the "total_carbon" objective.
    #: Duck-typed (scalar fields ci_use_g_per_kwh / lifetime_s / util /
    #: idle_frac / die_w plus `pe_active_w(node_nm)`) so core never
    #: imports a fleet layer.
    op: Any = None

    @property
    def gene_sizes(self) -> tuple[int, ...]:
        return (len(self.num_pes), self.rows.shape[1], len(self.rf_bytes),
                len(self.glb_kib), len(self.mults), len(self.dies))

    @property
    def size(self) -> int:
        n = 1
        for s in self.gene_sizes:
            n *= s
        return n

    def tables(self, device: str | torch.device | None = None) -> dict:
        """The space as tensors on `device` (default: the CUDA device).
        Every physical quantity is float32, as in the JAX package: numpy's
        float64 tables are rounded on their way to the device."""
        dev = resolve_device(device)

        def f32(x):
            return torch.tensor(np.asarray(x, np.float32), device=dev)

        def flag(x):
            return torch.tensor(np.asarray(x, bool), device=dev)

        t = {
            "rows": f32(self.rows), "cols": f32(self.cols),
            "num_pes": f32(self.num_pes), "rf": f32(self.rf_bytes),
            "glb": f32(self.glb_kib), "mult_area": f32(self.mult_area),
            # multiplier-array energy scale: area ratio vs the exact
            # design (approx multipliers are smaller AND lower power)
            "mult_escale": f32(self.mult_area
                               / self.mult_area[self.exact_idx]),
            "allowed": flag(self.mult_allowed),
            "fps": f32(self.fps_table),
            "dies": f32(self.dies),
            "die_ok": flag(self.die_ok),
            "exact_idx": int(self.exact_idx),
            "ci_fab": f32(carbonmod.CI_FAB_G_PER_KWH if self.ci_fab is None
                          else self.ci_fab),
            "fps_min": f32(self.fps_min),
        }
        if self.op is not None:
            t["op_ci_use"] = f32(self.op.ci_use_g_per_kwh)
            t["op_life_s"] = f32(self.op.lifetime_s)
            t["op_util"] = f32(self.op.util)
            t["op_idle_frac"] = f32(self.op.idle_frac)
            t["op_die_w"] = f32(self.op.die_w)
            t["op_pe_w"] = f32(self.op.pe_active_w(self.node_nm))
        return t

    def decode(self, genome_row: np.ndarray) -> gamod.Genome:
        return gamod.Genome(*(int(g) for g in genome_row))


def build_space(workload: str, node_nm: int, fps_min: float,
                max_accuracy_drop: float,
                mults: Sequence[mm.ApproxMultiplier] | None = None,
                accuracy_fn: gamod.AccuracyFn = gamod.proxy_accuracy_drop,
                ci_fab: float | None = None,
                dram_gbps: float = 19.2,
                op: Any = None,
                device: str | torch.device | None = None) -> DesignSpace:
    """Resolve the genome design space into gatherable arrays, including
    the FPS lattice from the batched dataflow model (run on `device`)."""
    if mults is None:
        from . import pareto
        mults = pareto.default_front()
    mults = list(mults)
    drops = np.array([accuracy_fn(m) for m in mults])
    allowed = drops <= max_accuracy_drop
    # mirror run_ga: the feasible set always contains an exact multiplier
    if not any(m.is_exact and ok for m, ok in zip(mults, allowed)):
        mults.append(mm.exact_multiplier())
        allowed = np.append(allowed, True)
    gamod._register(mults)
    exact_idx = next(i for i, m in enumerate(mults)
                     if m.is_exact and allowed[i])

    n_pe, n_aspect = len(accmod.VALID_PE_COUNTS), len(gamod.ASPECTS)
    rows = np.zeros((n_pe, n_aspect), np.int64)
    cols = np.zeros((n_pe, n_aspect), np.int64)
    for i, pes in enumerate(accmod.VALID_PE_COUNTS):
        for j, aspect in enumerate(gamod.ASPECTS):
            rows[i, j], cols[i, j] = gamod._pe_split(pes, aspect)

    glb = np.asarray(gamod.GLB_KIB_CHOICES, np.int64)
    dies = np.asarray(gamod.DIE_CHOICES, np.int64)
    n_die = len(dies)
    die_ok = np.zeros((n_pe, n_aspect, n_die), bool)
    for i, pes in enumerate(accmod.VALID_PE_COUNTS):
        for j in range(n_aspect):
            for di, d in enumerate(gamod.DIE_CHOICES):
                die_ok[i, j, di] = gamod.die_feasible(
                    int(cols[i, j]), pes, d)
    # FPS lattice: every (pe, aspect, glb, die) combo in one batched call
    ri, rj, rk, rd = np.meshgrid(np.arange(n_pe), np.arange(n_aspect),
                                 np.arange(len(glb)), np.arange(n_die),
                                 indexing="ij")
    fps_flat = dfmod.batched_fps(
        workload, rows[ri.ravel(), rj.ravel()], cols[ri.ravel(), rj.ravel()],
        glb[rk.ravel()], node_nm, dram_gbps, dies=dies[rd.ravel()],
        device=device)
    fps_table = fps_flat.cpu().numpy().reshape(n_pe, n_aspect, len(glb),
                                               n_die)

    return DesignSpace(
        workload=workload, node_nm=node_nm, fps_min=fps_min,
        max_accuracy_drop=max_accuracy_drop, ci_fab=ci_fab,
        mults=tuple(mults), rows=rows, cols=cols,
        num_pes=np.asarray(accmod.VALID_PE_COUNTS, np.int64),
        rf_bytes=np.asarray(gamod.RF_CHOICES, np.int64),
        glb_kib=glb,
        mult_area=np.array([m.area_nand2eq for m in mults]),
        mult_allowed=allowed,
        fps_table=fps_table, exact_idx=exact_idx,
        dies=dies, die_ok=die_ok, op=op)


# ---------------------------------------------------------------------------
# Population evaluation + GA step
# ---------------------------------------------------------------------------

def _metrics(pop: torch.Tensor, t: dict, node_nm: int,
             fps_penalty: float, objective: str = "cdp") -> dict:
    """Fitness of a (P, 6) genome tensor — pure gathers + elementwise
    tensor math, no Python per-genome work.  `objective` picks what the
    GA minimizes: "cdp" (embodied carbon x delay) or "total_carbon"
    (amortized embodied + operational gCO2e per inference; requires the
    op_* table scalars from `DesignSpace.op`)."""
    pe, aspect, rf, glb, mult, die = pop.unbind(1)
    fps = t["fps"][pe, aspect, glb, die]
    n_dies = t["dies"][die]
    die_area = accmod.area_total_mm2_arr(
        t["num_pes"][pe] / n_dies, t["rf"][rf], t["glb"][glb],
        t["mult_area"][mult], node_nm)
    area = n_dies * die_area
    carbon = carbonmod.multi_die_carbon_g_arr(die_area, n_dies, node_nm,
                                              t["ci_fab"])
    cdp = carbonmod.cdp_arr(carbon, fps)
    fps_min = t["fps_min"]
    # identical semantics to ga.evaluate: fps capped at the threshold
    # (speed beyond the requirement must not buy carbon headroom), with
    # a superlinear penalty under the floor.
    eff = torch.where(fps_min > 0, torch.minimum(fps, fps_min), fps)
    out = {"fps": fps, "area_mm2": area, "carbon_g": carbon, "cdp": cdp,
           "n_dies": n_dies, "die_area_mm2": die_area}
    if "op_pe_w" in t:
        # operational term: race-to-idle active energy + duty-cycle idle
        # tail, amortized embodied over lifetime inferences at the
        # duty-cycled rate.
        escale = t["mult_escale"][mult]
        p_active = (t["op_pe_w"] * t["num_pes"][pe]
                    * (0.5 + 0.5 * escale)
                    + t["op_die_w"] * torch.clamp(n_dies - 1.0, min=0.0))
        p_idle = t["op_idle_frac"] * p_active
        e_inf = (p_active / fps
                 + p_idle * torch.clamp(1.0 / eff - 1.0 / fps, min=0.0))
        op_g = e_inf / 3.6e6 * t["op_ci_use"]
        emb_g = carbon / (t["op_life_s"] * t["op_util"] * eff)
        out["energy_j_per_inf"] = e_inf
        out["operational_g_per_inf"] = op_g
        out["embodied_g_per_inf"] = emb_g
        out["total_g_per_inf"] = emb_g + op_g
    if objective == "total_carbon":
        if "op_pe_w" not in t:
            raise ValueError(
                "objective='total_carbon' needs DesignSpace.op (an "
                "operational-carbon model) to supply the op_* tables")
        fitness = out["total_g_per_inf"]
    elif objective == "cdp":
        fitness = carbonmod.cdp_arr(carbon, eff)
    else:
        raise ValueError(f"unknown objective {objective!r}")
    deficit = (fps_min - fps) / torch.clamp(fps_min, min=1e-9)
    penalized = fitness * (1.0 + fps_penalty * deficit * (1.0 + deficit))
    fitness = torch.where((fps_min > 0) & (fps < fps_min), penalized,
                          fitness)
    # constraint mask: accuracy-infeasible multiplier genes and uneven die
    # splits never score (inf, never NaN)
    feasible = t["allowed"][mult] & t["die_ok"][pe, aspect, die]
    out["fitness"] = torch.where(feasible, fitness, torch.inf)
    out["feasible"] = feasible
    return out


def evaluate_population(pop, tables: dict, node_nm: int,
                        fps_penalty: float = 50.0,
                        objective: str = "cdp") -> dict:
    """Metrics of a (P, 6) genome array (numpy or tensor), on the device
    of `tables`."""
    if not torch.is_tensor(pop):
        pop = torch.from_numpy(np.asarray(pop))
    pop = pop.to(device=tables["fps"].device, dtype=torch.int64)
    return _metrics(pop, tables, node_nm, fps_penalty, objective)


def _random_genes(gen: torch.Generator, n: int, gene_sizes: tuple[int, ...],
                  allowed: torch.Tensor) -> torch.Tensor:
    """(n, 6) random genomes; the multiplier gene is drawn ONLY from the
    accuracy-feasible set (constraint satisfaction by construction: the
    set always holds the exact multiplier, so its weights are never all
    zero).  The die gene is uniform — its feasibility depends on the
    (pe, aspect) genes, so uneven splits are repaired by `_snap_die_gene`
    instead."""
    cols = []
    for i in range(N_GENES):
        if i == MULT_GENE:
            cols.append(torch.multinomial(allowed.float(), n,
                                          replacement=True, generator=gen))
        else:
            cols.append(torch.randint(0, gene_sizes[i], (n,), generator=gen,
                                      device=allowed.device))
    return torch.stack(cols, dim=1)


def _snap_die_gene(pop: torch.Tensor, die_ok: torch.Tensor) -> torch.Tensor:
    """Repair uneven die splits to the always-feasible monolithic gene 0
    (DIE_CHOICES[0] == 1)."""
    ok = die_ok[pop[:, 0], pop[:, 1], pop[:, DIE_GENE]]
    out = pop.clone()
    out[:, DIE_GENE] = torch.where(ok, pop[:, DIE_GENE], 0)
    return out


def _ga_step(gen: torch.Generator, pop: torch.Tensor, tables: dict,
             node_nm: int, gene_sizes: tuple[int, ...], tournament: int,
             elitism: int, p_crossover: float, p_mutate: float,
             fps_penalty: float, objective: str = "cdp"):
    """One generation — selection, crossover, mutation, constraint
    masking — as whole-population tensor ops on the population's device,
    with no sync to the host.  Returns (next population, best fitness of
    `pop`, best genome of `pop`) as device tensors."""
    t = tables
    P = pop.shape[0]
    dev = pop.device
    fit = _metrics(pop, t, node_nm, fps_penalty, objective)["fitness"]
    order = torch.argsort(fit, stable=True)

    # tournament selection: two parents per child slot; the first of
    # equal-fitness entrants wins
    idx = torch.randint(0, P, (2, P, tournament), generator=gen, device=dev)
    win = torch.gather(idx, -1, torch.argmin(fit[idx], dim=-1,
                                             keepdim=True))[..., 0]
    p1, p2 = pop[win[0]], pop[win[1]]

    # uniform crossover (per pair with prob p_crossover, per gene 50/50)
    pair_cross = torch.rand((P, 1), generator=gen, device=dev) < p_crossover
    from_p2 = ((torch.rand((P, N_GENES), generator=gen, device=dev) < 0.5)
               & pair_cross)
    child = torch.where(from_p2, p2, p1)

    # per-gene mutation; the mult gene resamples within the feasible set
    mut = torch.rand((P, N_GENES), generator=gen, device=dev) < p_mutate
    child = torch.where(mut, _random_genes(gen, P, gene_sizes,
                                           t["allowed"]), child)

    # elitism: best `elitism` genomes survive
    child[:elitism] = pop[order[:elitism]]

    # constraint masking, applied last so even seeded-infeasible elites
    # cannot carry an accuracy-infeasible multiplier gene (snap to the
    # exact multiplier) or an uneven die split (snap to 1 die) forward.
    mult = child[:, MULT_GENE]
    child[:, MULT_GENE] = torch.where(t["allowed"][mult], mult,
                                      t["exact_idx"])
    child = _snap_die_gene(child, t["die_ok"])
    # the best by a one-element index: a 0-dim index is read on the host
    best = order[:1]
    return child, fit[best][0], pop[best][0]


@dataclasses.dataclass
class BatchedGAResult:
    best: gamod.Evaluated           # decoded + re-scored by the reference
    best_genome: gamod.Genome
    history: list[float]            # best fitness per generation
    population: np.ndarray          # (P, 6) final genomes
    metrics: dict                   # final-population arrays (np)
    space: DesignSpace


def run_ga_batched(workload: str, node_nm: int, fps_min: float,
                   max_accuracy_drop: float,
                   mults: Sequence[mm.ApproxMultiplier] | None = None,
                   accuracy_fn: gamod.AccuracyFn = gamod.proxy_accuracy_drop,
                   cfg: BatchedGAConfig | None = None,
                   ci_fab: float | None = None,
                   space: DesignSpace | None = None,
                   op: Any = None,
                   device: str | torch.device | None = None
                   ) -> BatchedGAResult:
    """Carbon-minimizing GA over a whole population per device step on
    `device` (default: the CUDA device), objective per `cfg.objective`:
    CDP, or total carbon when an operational model is supplied.  The
    returned `best` is re-evaluated through the numpy reference
    (`ga.evaluate`), so reported CDP numbers are the reference model's."""
    cfg = cfg or BatchedGAConfig()
    dev = resolve_device(device)
    if space is None:
        space = build_space(workload, node_nm, fps_min, max_accuracy_drop,
                            mults=mults, accuracy_fn=accuracy_fn,
                            ci_fab=ci_fab, op=op, device=dev)
    elif op is not None and space.op is None:
        space = dataclasses.replace(space, op=op)
    if cfg.objective == "total_carbon" and space.op is None:
        raise ValueError("objective='total_carbon' requires an "
                         "operational-carbon model (op=... or space.op)")
    # a prebuilt space must describe THIS problem: the GA searches on
    # the space's tables but reports through the args
    got = (space.workload, space.node_nm, space.fps_min,
           space.max_accuracy_drop)
    want = (workload, node_nm, fps_min, max_accuracy_drop)
    if got != want:
        raise ValueError(f"space {got} != requested problem {want}")
    tables = space.tables(dev)
    gene_sizes = space.gene_sizes
    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.seed)
    pop = _random_genes(gen, cfg.pop_size, gene_sizes, tables["allowed"])
    pop = _snap_die_gene(pop, tables["die_ok"])

    history: list[float] = []
    for _ in range(cfg.generations):
        pop, best_fit, _ = _ga_step(
            gen, pop, tables, space.node_nm, gene_sizes, cfg.tournament,
            cfg.elitism, cfg.p_crossover, cfg.p_mutate_gene, cfg.fps_penalty,
            cfg.objective)
        history.append(float(best_fit))

    final = evaluate_population(pop, tables, space.node_nm, cfg.fps_penalty,
                                cfg.objective)
    final = {k: v.cpu().numpy() for k, v in final.items()}
    pop_np = pop.cpu().numpy()
    best_row = pop_np[int(np.argmin(final["fitness"]))]
    history.append(float(final["fitness"].min()))

    genome = space.decode(best_row)
    best = gamod.evaluate(genome, workload, node_nm, space.mults, fps_min,
                          gamod.GAConfig(fps_penalty=cfg.fps_penalty,
                                         seed=cfg.seed),
                          ci_fab=space.ci_fab)
    return BatchedGAResult(best=best, best_genome=genome, history=history,
                           population=pop_np, metrics=final, space=space)


def exhaustive_population(space: DesignSpace,
                          max_dies: int | None = None) -> np.ndarray:
    """Every genome of the space as an (N, 6) int64 array, optionally
    restricted to designs of at most `max_dies` dies."""
    grids = np.meshgrid(*(np.arange(s) for s in space.gene_sizes),
                        indexing="ij")
    pop = np.stack([g.ravel() for g in grids], axis=1).astype(np.int64)
    if max_dies is not None:
        pop = pop[space.dies[pop[:, DIE_GENE]] <= max_dies]
    return pop


def exhaustive_best(space: DesignSpace, fps_penalty: float = 50.0,
                    max_dies: int | None = None,
                    objective: str = "cdp",
                    device: str | torch.device | None = None
                    ) -> tuple[gamod.Genome, dict]:
    """Ground truth by brute force: evaluate EVERY genome in the space in
    one batched call on `device` (the space is small enough that the
    batched model makes exhaustive search cheaper than the sequential
    GA's first generation).  Returns (argmin genome, its metrics).
    `max_dies=1` restricts to monolithic designs — the baseline the
    multi-die scenarios are compared against."""
    pop = exhaustive_population(space, max_dies)
    met = evaluate_population(pop, space.tables(device), space.node_nm,
                              fps_penalty, objective)
    met = {k: v.cpu().numpy() for k, v in met.items()}
    i = int(np.argmin(met["fitness"]))
    return space.decode(pop[i]), {k: v[i] for k, v in met.items()}
