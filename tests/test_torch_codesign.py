"""repro_torch's co-design core against the JAX package.

The same inputs go through both packages' workloads, area, carbon,
dataflow, target, GA, batched-GA, calibration and codesign modules, with
the PyTorch side on the CPU (`device="cpu"`).  Tolerances:

* the numpy forks (`workloads`, the scalar area/carbon/dataflow models,
  `ga`, `target`, `codesign`'s sweeps and the numpy GA): exactly equal,
  field for field, on the same inputs and the same numpy RNG;
* the float32 array forms (`batched_fps`, `*_arr`, `evaluate_population`)
  against JAX's: rtol 1e-6.  Both compute in float32, but XLA contracts
  some multiply-adds into FMAs, divides by constants through reciprocals
  and sums the layers in its own order, so results differ by a few ulps;
  every `inf` (masked genome) sits at the same place;
* the torch GA cannot replay JAX's threefry stream, so it is held to the
  numpy GA's selected design and to `exhaustive_best`, as the JAX
  package's own tests hold its GA;
* the total-carbon objective takes the port's own
  `fleet.total.OperationalModel` on both sides (the JAX package's GA and
  codesign read it duck-typed); tests/test_torch_fleet.py holds it equal
  to the JAX package's model field by field.
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import accelerator as jacc
from repro.core import calibrate as jcal
from repro.core import carbon as jcb
from repro.core import codesign as jcd
from repro.core import dataflow as jdf
from repro.core import ga as jga
from repro.core import ga_batched as jgb
from repro.core import multipliers as jmm
from repro.core import netlist as jnl
from repro.core import target as jtg
from repro.core import workloads as jwl
from repro_torch.core import accelerator as acc
from repro_torch.core import calibrate as cal
from repro_torch.core import carbon as cb
from repro_torch.core import codesign as cd
from repro_torch.core import dataflow as df
from repro_torch.core import ga
from repro_torch.core import ga_batched as gb
from repro_torch.core import multipliers as mm
from repro_torch.core import target as tg
from repro_torch.core import workloads as wl
from repro_torch.fleet.total import OperationalModel
from repro_torch.launch import accuracy as acc_launch
from repro_torch.launch import codesign as launch

torch.set_num_threads(1)

CPU = "cpu"
RTOL = 1e-6
_MASK = np.random.default_rng(3).random(
    len(jnl.bw8().prunable_gates())) < 0.03


def _mults(pkg_mm):
    """The JAX package's fast GA library (exact, trunc1x1-3x3) plus one
    gate-pruned multiplier, from one package's multiplier module."""
    return [pkg_mm.exact_multiplier(), pkg_mm.truncated(1, 1),
            pkg_mm.truncated(2, 2), pkg_mm.truncated(3, 3),
            pkg_mm.pruned(_MASK, name="cd_pruned3")]


def _flat(x):
    """Every leaf of a (nested) dataclass / tuple / list / dict."""
    if dataclasses.is_dataclass(x):
        x = [getattr(x, f.name) for f in dataclasses.fields(x)]
    elif isinstance(x, dict):
        x = list(x.items())
    if isinstance(x, (list, tuple)):
        return [leaf for v in x for leaf in _flat(v)]
    return [x]


def _same(a, b) -> bool:
    """Exactly equal, leaf for leaf (a NaN equal to a NaN)."""
    fa, fb = _flat(a), _flat(b)
    if len(fa) != len(fb):
        return False
    for x, y in zip(fa, fb):
        if isinstance(x, float) and isinstance(y, float) and \
                math.isnan(x) and math.isnan(y):
            continue
        if type(x) is not type(y) or x != y:
            return False
    return True


def _tied(a, b) -> bool:
    """Two GA winners of equal standing: the same constrained fitness,
    carbon, multiplier and die count.  Designs that differ only in the PE
    array's aspect tie exactly once both exceed the FPS floor (fitness
    caps FPS at the floor), and two GAs with different random streams
    may return either."""
    return (a.fitness == b.fitness and a.carbon_g == b.carbon_g
            and a.area_mm2 == b.area_mm2 and a.n_dies == b.n_dies
            and a.config.multiplier == b.config.multiplier
            and a.config.num_pes == b.config.num_pes)


def _lattice():
    """The GA's full (pe, aspect, glb, die) configuration lattice."""
    rows, cols, glbs, dies = [], [], [], []
    for pes in acc.VALID_PE_COUNTS:
        for aspect in ga.ASPECTS:
            r, c = ga._pe_split(pes, aspect)
            for g in ga.GLB_KIB_CHOICES:
                for d in ga.DIE_CHOICES:
                    rows.append(r), cols.append(c), glbs.append(g)
                    dies.append(d)
    return tuple(np.array(v) for v in (rows, cols, glbs, dies))


# --- numpy forks: exactly equal ------------------------------------------------

@pytest.mark.parametrize("workload", sorted(jwl.WORKLOADS))
def test_workload_tables_equal(workload):
    mine, ref = wl.WORKLOADS[workload](), jwl.WORKLOADS[workload]()
    assert _same(mine, ref)
    assert [type(l).__name__ for l in mine] == \
        [type(l).__name__ for l in ref]
    assert wl.total_macs(mine) == jwl.total_macs(ref)
    assert [l.weight_bytes + l.ifmap_bytes + l.ofmap_bytes for l in mine] \
        == [l.weight_bytes + l.ifmap_bytes + l.ofmap_bytes for l in ref]


@pytest.mark.parametrize("node", [7, 14, 28])
def test_area_model_equal(node):
    for pes in acc.VALID_PE_COUNTS:
        for mult in ("exact", "trunc2x2", "trunc4x4"):
            mine = acc.nvdla_default(pes, node, mult)
            ref = jacc.nvdla_default(pes, node, mult)
            assert _same(mine, ref)
            assert _same(acc.area_model(mine), jacc.area_model(ref))
            assert acc.area_model(mine).mult_fraction == \
                jacc.area_model(ref).mult_fraction
            for n in ga.DIE_CHOICES:
                assert acc.die_area_mm2(mine, n) == jacc.die_area_mm2(ref, n)
    bad = acc.AcceleratorConfig(8, 4, 32, 64, "exact", node)
    with pytest.raises(ValueError):
        acc.area_model(bad)


@pytest.mark.parametrize("node", [7, 14, 28])
def test_embodied_and_multi_die_carbon_equal(node):
    for area in np.geomspace(0.05, 500, 25):
        a = float(area)
        assert cb.murphy_yield(a, node) == jcb.murphy_yield(a, node)
        assert cb.dies_per_wafer(a) == jcb.dies_per_wafer(a)
        for ci in (None, 50.0, 820.0):
            assert cb.cfpa(node, a, ci) == jcb.cfpa(node, a, ci)
            assert _same(cb.embodied_carbon(a, node, ci),
                         jcb.embodied_carbon(a, node, ci))
            for n in (1, 2, 4):
                mine = cb.multi_die_carbon(a, n, node, ci)
                ref = jcb.multi_die_carbon(a, n, node, ci)
                assert _same(mine, ref)
                assert mine.total_area_mm2 == ref.total_area_mm2
        assert cb.cdp(a, 30.0) == jcb.cdp(a, 30.0)
    assert cb.node_frequency(node) == jcb.node_frequency(node)


@pytest.mark.parametrize("workload", sorted(jwl.WORKLOADS))
def test_workload_perf_equal_at_every_die_count(workload):
    for pes, aspect, glb in ((64, "square", 64), (512, "wide", 256),
                             (2048, "tall", 1024), (256, "square", 128)):
        r, c = ga._pe_split(pes, aspect)
        mine = acc.AcceleratorConfig(r, c, 32, glb, "exact", 7)
        ref = jacc.AcceleratorConfig(r, c, 32, glb, "exact", 7)
        for n in ga.DIE_CHOICES:
            p, q = df.workload_perf(workload, mine, n), \
                jdf.workload_perf(workload, ref, n)
            assert _same(p, q)
            assert [l.cycles for l in p.layers] == [l.cycles for l in q.layers]
            assert df.fps(workload, mine, n) == jdf.fps(workload, ref, n)


def test_ga_evaluate_equal_on_random_genomes():
    """Every genome of a random population, uneven die splits (inf
    fitness) included, scores field for field as the reference does."""
    tm, jm = _mults(mm), _mults(jmm)
    ga._register(tm), jga._register(jm)
    rng = np.random.default_rng(0)
    sizes = (len(acc.VALID_PE_COUNTS), len(ga.ASPECTS), len(ga.RF_CHOICES),
             len(ga.GLB_KIB_CHOICES), len(tm), len(ga.DIE_CHOICES))
    n_inf = 0
    for row in np.stack([rng.integers(0, n, 64) for n in sizes], 1):
        genes = [int(g) for g in row]
        for fps_min, ci in ((30.0, None), (120.0, 50.0), (0.0, None)):
            mine = ga.evaluate(ga.Genome(*genes), "vgg16", 7, tm, fps_min,
                               ga.GAConfig(), ci)
            ref = jga.evaluate(jga.Genome(*genes), "vgg16", 7, jm, fps_min,
                               jga.GAConfig(), ci)
            assert _same(mine, ref), (genes, fps_min)
            n_inf += math.isinf(mine.fitness)
    assert n_inf > 0
    assert ga.proxy_accuracy_drop(tm[4]) == jga.proxy_accuracy_drop(jm[4])


@pytest.mark.parametrize("node", [7, 14, 28])
def test_exact_baseline_and_sweeps_equal(node):
    tm, jm = _mults(mm), _mults(jmm)
    for workload in ("vgg16", "resnet50"):
        for fps_min in (30.0, 1e6):          # 1e6: nothing meets it
            assert _same(ga.exact_baseline(workload, node, fps_min),
                         jga.exact_baseline(workload, node, fps_min))
        assert _same(ga.exact_baseline(workload, node, 30.0, 50.0),
                     jga.exact_baseline(workload, node, 30.0, 50.0))
        assert _same(cd.sweep_exact_configs(workload, node),
                     jcd.sweep_exact_configs(workload, node))
        for drop in (0.0, 0.5, 2.0):
            assert _same(cd.approx_only_sweep(workload, node, drop, tm),
                         jcd.approx_only_sweep(workload, node, drop, jm))
    base = acc.nvdla_default(512, node)
    assert _same(ga.approx_variant(base, tm[2]),
                 jga.approx_variant(jacc.nvdla_default(512, node), jm[2]))


def test_hardware_target_and_genome_to_target_equal():
    for spec in ("", "model=4,data=2", "data=2, model=1", "pod=2,model=2"):
        assert tg.parse_mesh_spec(spec) == jtg.parse_mesh_spec(spec)
    for bad in ("modle=4", "model=4,model=2", "model=0", "model=x"):
        with pytest.raises(ValueError):
            tg.parse_mesh_spec(bad)
        with pytest.raises(ValueError):
            jtg.parse_mesh_spec(bad)
    die, jdie = acc.nvdla_default(128, 7), jacc.nvdla_default(128, 7)
    for mk in (lambda m, d: m.HardwareTarget(d, 4, (("data", 1),
                                                     ("model", 4))),
               lambda m, d: m.HardwareTarget.monolithic(d, data=2),
               lambda m, d: m.HardwareTarget.from_mesh_spec(d, "model=2")):
        t, j = mk(tg, die), mk(jtg, jdie)
        assert _same(t, j)
        for attr in ("total_pes", "die_area_mm2", "total_area_mm2",
                     "tp_degree"):
            assert getattr(t, attr) == getattr(j, attr)
        assert t.mesh_spec() == j.mesh_spec()
        assert _same(t.carbon(), j.carbon())
        assert _same(t.carbon(50.0), j.carbon(50.0))
        assert t.fps("vgg16") == j.fps("vgg16")
    for kw in (dict(n_dies=0), dict(n_dies=2, mesh_axes=(("model", 4),)),
               dict(n_dies=2, mesh_axes=(("modell", 2),)),
               dict(n_dies=2, mesh_axes=(("data", 2),))):
        with pytest.raises(ValueError):
            tg.HardwareTarget(die=die, **kw)
    assert not hasattr(tg.HardwareTarget, "make_mesh")
    tm, jm = _mults(mm), _mults(jmm)
    for genes in ((3, 0, 0, 2, 0, 2), (5, 1, 2, 4, 3, 1), (1, 2, 1, 0, 4, 0)):
        assert _same(ga.Genome(*genes).to_target(tm, 7),
                     jga.Genome(*genes).to_target(jm, 7))
    with pytest.raises(ValueError):
        ga.Genome(0, 2, 0, 0, 0, 2).to_target(tm, 7)   # tall 64: cols 4


@pytest.mark.parametrize("workload", ["vgg16", "resnet50"])
def test_numpy_ga_equal_to_reference(workload):
    """Same numpy RNG, same GA: the same best, population and history."""
    for fps_min in (30.0, 120.0):
        mine = ga.run_ga(workload, 7, fps_min, 2.0, mults=_mults(mm),
                         cfg=ga.GAConfig(pop_size=32, generations=16))
        ref = jga.run_ga(workload, 7, fps_min, 2.0, mults=_mults(jmm),
                         cfg=jga.GAConfig(pop_size=32, generations=16))
        assert _same(mine.best, ref.best)
        assert mine.history == ref.history
        assert _same(mine.population, ref.population)
        assert [m.name for m in mine.mults] == [m.name for m in ref.mults]


# --- array forms against JAX: rtol 1e-6 ----------------------------------------

@pytest.mark.parametrize("workload", sorted(jwl.WORKLOADS))
def test_batched_fps_matches_jax_on_the_full_lattice(workload):
    rows, cols, glbs, dies = _lattice()
    for node in (7, 14, 28):
        want = np.asarray(jdf.batched_fps(workload, rows, cols, glbs, node,
                                          dies=dies))
        got = df.batched_fps(workload, rows, cols, glbs, node, dies=dies,
                             device=CPU)
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)
    # and against the float64 scalar model, as the JAX package holds its own
    i = np.arange(0, len(rows), 17)
    ref = [df.workload_perf(workload, acc.AcceleratorConfig(
        int(rows[j]), int(cols[j]), 32, int(glbs[j]), "exact", 7),
        int(dies[j])).fps for j in i]
    got = df.batched_fps(workload, rows[i], cols[i], glbs[i], 7,
                         dies=dies[i], device=CPU)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4)


def test_batched_fps_chunks_the_config_axis(monkeypatch):
    rows, cols, glbs, dies = _lattice()
    whole = df.batched_fps("resnet50", rows, cols, glbs, 7, dies=dies,
                           device=CPU)
    # four configs per chunk
    monkeypatch.setattr(df, "CHUNK_BYTES",
                        4 * 4 * len(df.workload_table("resnet50").c) * 225)
    chunked = df.batched_fps("resnet50", rows, cols, glbs, 7, dies=dies,
                             device=CPU)
    assert torch.equal(whole, chunked)


@pytest.mark.parametrize("node", [7, 14, 28])
def test_carbon_arrays_match_jax(node):
    areas = np.geomspace(0.05, 500, 25).astype(np.float32)
    ta, ja = torch.from_numpy(areas), jnp.asarray(areas)
    for ci in (None, 50.0, 820.0):
        got = cb.embodied_carbon_g_arr(ta, node, ci)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(
            got.numpy(), np.asarray(jcb.embodied_carbon_g_arr(ja, node, ci)),
            rtol=RTOL)
        for n in (1.0, 2.0, 4.0):
            got = cb.multi_die_carbon_g_arr(ta, torch.tensor(n), node, ci)
            want = jcb.multi_die_carbon_g_arr(ja, jnp.float32(n), node, ci)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=RTOL)
    np.testing.assert_allclose(
        cb.murphy_yield_arr(ta, 0.2).numpy(),
        np.asarray(jcb.murphy_yield_arr(ja, 0.2)), rtol=RTOL)
    # the scalar model in float64, as the JAX package holds its arrays
    ref = [cb.embodied_carbon(float(a), node).total_g for a in areas]
    np.testing.assert_allclose(cb.embodied_carbon_g_arr(ta, node).numpy(),
                               ref, rtol=1e-5)


def test_area_array_matches_jax():
    pes = np.array([64.0, 256.0, 2048.0, 512.0], np.float32)
    rf = np.array([32.0, 64.0, 128.0, 32.0], np.float32)
    glb = np.array([64.0, 128.0, 512.0, 1024.0], np.float32)
    area = np.array([mm.get_multiplier(n).area_nand2eq for n in
                     ("exact", "trunc2x2", "trunc4x4", "trunc1x1")],
                    np.float32)
    for node in (7, 14, 28):
        got = acc.area_total_mm2_arr(*map(torch.from_numpy,
                                          (pes, rf, glb, area)), node)
        want = jacc.area_total_mm2_arr(*map(jnp.asarray,
                                            (pes, rf, glb, area)), node)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)


# --- population metrics against JAX --------------------------------------------

def _spaces(workload="vgg16", node=7, fps_min=30.0, drop=2.0):
    return (gb.build_space(workload, node, fps_min, drop, mults=_mults(mm),
                           device=CPU),
            jgb.build_space(workload, node, fps_min, drop,
                            mults=_mults(jmm)))


@pytest.mark.parametrize("objective", ["cdp", "total_carbon"])
def test_evaluate_population_matches_jax_on_every_genome(objective):
    op = OperationalModel()
    mine, ref = _spaces()
    mine = dataclasses.replace(mine, op=op)
    ref = dataclasses.replace(ref, op=op)
    np.testing.assert_allclose(mine.fps_table, ref.fps_table, rtol=RTOL)
    for f in ("rows", "cols", "num_pes", "rf_bytes", "glb_kib", "mult_area",
              "mult_allowed", "dies", "die_ok"):
        np.testing.assert_array_equal(getattr(mine, f), getattr(ref, f))
    assert mine.exact_idx == ref.exact_idx
    assert mine.gene_sizes == ref.gene_sizes and mine.size == ref.size
    pop = gb.exhaustive_population(mine)
    assert len(pop) == mine.size
    # the metrics on the same lattice: the FPS-floor penalty multiplies a
    # lattice ulp by up to ~50x, so the lattice is held on its own above
    same = dataclasses.replace(mine, fps_table=ref.fps_table)
    got = gb.evaluate_population(pop, same.tables(CPU), 7,
                                 objective=objective)
    want = jgb.evaluate_population(jnp.asarray(pop, jnp.int32),
                                   ref.tables(), 7, objective=objective)
    assert set(got) == set(want)
    for k, v in got.items():
        w = np.asarray(want[k])
        v = v.numpy()
        if k == "feasible":
            np.testing.assert_array_equal(v, w)
            continue
        assert v.dtype == np.float32, k
        assert not np.isnan(v).any(), k
        np.testing.assert_array_equal(np.isinf(v), np.isinf(w))
        fin = np.isfinite(w)
        np.testing.assert_allclose(v[fin], w[fin], rtol=RTOL, err_msg=k)
    g, met = gb.exhaustive_best(mine, objective=objective, device=CPU)
    jg, jmet = jgb.exhaustive_best(ref, objective=objective)
    assert dataclasses.astuple(g) == dataclasses.astuple(jg) or \
        float(met["fitness"]) == pytest.approx(float(jmet["fitness"]),
                                               rel=RTOL)
    assert float(met["fitness"]) == pytest.approx(float(jmet["fitness"]),
                                                  rel=RTOL)


def test_tables_are_float32_on_the_device():
    space, _ = _spaces()
    t = dataclasses.replace(space, op=OperationalModel()).tables(CPU)
    for k, v in t.items():
        if k == "exact_idx":
            assert v == space.exact_idx
        elif k in ("allowed", "die_ok"):
            assert v.dtype == torch.bool
        else:
            assert v.dtype == torch.float32, k
            assert v.device.type == "cpu"
    assert t["mult_escale"][space.exact_idx] == 1.0


def test_fitness_is_inf_never_nan_without_an_fps_floor():
    space, _ = _spaces(fps_min=0.0)
    pop = gb.exhaustive_population(space)
    met = gb.evaluate_population(pop, space.tables(CPU), 7)
    fit = met["fitness"]
    assert not torch.isnan(fit).any()
    assert torch.equal(torch.isinf(fit), ~met["feasible"])
    # no floor: fitness is plain CDP wherever the genome is feasible
    ok = met["feasible"]
    assert torch.equal(fit[ok], met["cdp"][ok])


# --- the torch GA on the CPU ---------------------------------------------------

@pytest.mark.parametrize("workload", ["vgg16", "resnet50"])
def test_torch_ga_selects_the_numpy_ga_design(workload):
    rb = gb.run_ga_batched(
        workload, 7, 30.0, 2.0, mults=_mults(mm),
        cfg=gb.BatchedGAConfig(pop_size=2048, generations=8, seed=0),
        device=CPU)
    rn = ga.run_ga(workload, 7, 30.0, 2.0, mults=_mults(mm),
                   cfg=ga.GAConfig(pop_size=32, generations=16, seed=0))
    assert rb.best.config == rn.best.config
    assert rb.best.n_dies == rn.best.n_dies
    assert rb.best.cdp == pytest.approx(rn.best.cdp, rel=1e-6)
    g_ex, met_ex = gb.exhaustive_best(rb.space, device=CPU)
    assert rb.best.fitness <= float(met_ex["fitness"]) * (1 + 1e-4)
    # the JAX package's batched GA lands on the same design, or a tie
    rj = jgb.run_ga_batched(
        workload, 7, 30.0, 2.0, mults=_mults(jmm),
        cfg=jgb.BatchedGAConfig(pop_size=2048, generations=8, seed=0))
    assert _tied(rb.best, rj.best)


def test_torch_ga_deterministic_per_seed_and_improves():
    kw = dict(mults=_mults(mm), device=CPU)
    r1, r2 = (gb.run_ga_batched(
        "vgg16", 7, 120.0, 2.0,
        cfg=gb.BatchedGAConfig(pop_size=256, generations=5, seed=11), **kw)
        for _ in range(2))
    assert r1.best.config == r2.best.config
    assert r1.history == r2.history
    np.testing.assert_array_equal(r1.population, r2.population)
    assert r1.history[-1] <= r1.history[0]
    assert len(r1.history) == 6
    r3 = gb.run_ga_batched(
        "vgg16", 7, 120.0, 2.0,
        cfg=gb.BatchedGAConfig(pop_size=256, generations=5, seed=12), **kw)
    assert not np.array_equal(r1.population, r3.population)


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_masking_never_admits_infeasible_genomes(seed):
    max_drop = 0.5  # excludes trunc2x2 / trunc3x3 under the proxy model
    res = gb.run_ga_batched(
        "vgg16", 7, 30.0, max_drop, mults=_mults(mm),
        cfg=gb.BatchedGAConfig(pop_size=128, generations=4, seed=seed),
        device=CPU)
    space, pop = res.space, res.population
    assert not space.mult_allowed.all()
    for g, n in zip(pop.T, space.gene_sizes):
        assert (g >= 0).all() and (g < n).all()
    assert space.mult_allowed[pop[:, gb.MULT_GENE]].all()
    assert space.die_ok[pop[:, 0], pop[:, 1], pop[:, gb.DIE_GENE]].all()
    assert res.metrics["feasible"].all()
    assert ga.proxy_accuracy_drop(
        space.mults[res.best_genome.mult_idx]) <= max_drop


@pytest.mark.parametrize("seed", [7, 8])
def test_masking_repairs_seeded_infeasible_population(seed):
    space = gb.build_space("vgg16", 7, 30.0, 0.5, mults=_mults(mm),
                           device=CPU)
    t = space.tables(CPU)
    bad_idx = int(np.flatnonzero(~space.mult_allowed)[0])
    rng = np.random.default_rng(seed)
    pop = np.stack([rng.integers(0, n, 64) for n in space.gene_sizes], 1)
    pop[:, gb.MULT_GENE] = bad_idx
    met = gb.evaluate_population(pop, t, 7)
    assert torch.isinf(met["fitness"]).all()
    gen = torch.Generator().manual_seed(seed)
    new_pop, best_fit, _ = gb._ga_step(
        gen, torch.from_numpy(pop), t, 7, space.gene_sizes, 3, 2, 0.7, 0.25,
        50.0)
    assert math.isinf(float(best_fit))
    new_pop = new_pop.numpy()
    assert space.mult_allowed[new_pop[:, gb.MULT_GENE]].all()
    assert space.die_ok[new_pop[:, 0], new_pop[:, 1],
                        new_pop[:, gb.DIE_GENE]].all()


def test_prebuilt_space_must_match_problem_and_objective_needs_op():
    space = gb.build_space("vgg16", 7, 30.0, 2.0, mults=_mults(mm),
                           device=CPU)
    with pytest.raises(ValueError, match="requested problem"):
        gb.run_ga_batched("resnet50", 7, 30.0, 2.0, space=space, device=CPU,
                          cfg=gb.BatchedGAConfig(pop_size=32, generations=1))
    with pytest.raises(ValueError, match="total_carbon"):
        gb.run_ga_batched("vgg16", 7, 30.0, 2.0, space=space, device=CPU,
                          cfg=gb.BatchedGAConfig(pop_size=32, generations=1,
                                                 objective="total_carbon"))
    with pytest.raises(ValueError, match="objective"):
        gb.evaluate_population(gb.exhaustive_population(space)[:4],
                               space.tables(CPU), 7, objective="speed")


def test_torch_ga_fires_the_die_gene_when_one_die_cannot_reach_the_floor():
    res = gb.run_ga_batched(
        "vgg16", 7, 120.0, 2.0, mults=_mults(mm),
        cfg=gb.BatchedGAConfig(pop_size=1024, generations=8, seed=0),
        device=CPU)
    assert res.best.n_dies > 1 and res.best.fps >= 120.0
    mono, mono_met = gb.exhaustive_best(res.space, max_dies=1, device=CPU)
    assert mono.n_dies == 1
    assert res.best.fitness < float(mono_met["fitness"])
    op = OperationalModel()
    rt = gb.run_ga_batched(
        "vgg16", 7, 120.0, 2.0, mults=_mults(mm), op=op, device=CPU,
        cfg=gb.BatchedGAConfig(pop_size=512, generations=6, seed=0,
                               objective="total_carbon"))
    g_tot, m_tot = gb.exhaustive_best(dataclasses.replace(rt.space, op=op),
                                      objective="total_carbon", device=CPU)
    assert rt.metrics["total_g_per_inf"].min() <= \
        float(m_tot["total_g_per_inf"]) * (1 + 1e-4)


# --- codesign: scenarios, frontier, total carbon, reproduction -----------------

def test_run_scenarios_matches_reference():
    scen = [cd.Scenario("vgg16", 7, ci_fab=50.0), cd.Scenario("vgg16", 7)]
    jscen = [jcd.Scenario("vgg16", 7, ci_fab=50.0), jcd.Scenario("vgg16", 7)]
    assert [s.name for s in scen] == [s.name for s in jscen]
    c = cal.identity()
    mine = cd.run_scenarios(scen, mults=_mults(mm), calibration=c,
                            cfg=gb.BatchedGAConfig(pop_size=512,
                                                   generations=6, seed=0),
                            device=CPU)
    ref = jcd.run_scenarios(jscen, mults=_mults(jmm),
                            cfg=jgb.BatchedGAConfig(pop_size=512,
                                                    generations=6, seed=0))
    for r, j in zip(mine, ref, strict=True):
        assert _tied(r.best, j.best)
        assert _same(r.exact, j.exact) and _same(r.mono, j.mono)
        assert r.ga_reduction == j.ga_reduction > 0
        assert r.cdp_calibrated is None
        d, e = r.to_dict(), j.to_dict()
        for key in ("scenario", "best_monolithic", "exact_baseline",
                    "ga_reduction"):
            assert d[key] == e[key], key
        assert r.frontier and r.frontier[0]["cdp"] > 0
    assert mine[0].best.carbon_g < mine[1].best.carbon_g


def test_population_frontier_equal_on_the_same_metrics():
    space, _ = _spaces()
    met = gb.evaluate_population(gb.exhaustive_population(space),
                                 space.tables(CPU), 7)
    met = {k: v.numpy() for k, v in met.items()}
    for k in (4, 16, 1000):
        mine = cd.population_frontier(met, k)
        assert mine == jcd.population_frontier(met, k)
        assert 0 < len(mine) <= k
    none = dict(met, feasible=np.zeros_like(met["feasible"]))
    assert cd.population_frontier(none) == [] == \
        jcd.population_frontier(none)


def test_run_total_carbon_matches_reference():
    op = OperationalModel()
    scen = [cd.Scenario("vgg16", 7), cd.Scenario("resnet50", 14, 50.0)]
    jscen = [jcd.Scenario("vgg16", 7), jcd.Scenario("resnet50", 14, 50.0)]
    mine = cd.run_total_carbon(scen, op, mults=_mults(mm), device=CPU)
    ref = jcd.run_total_carbon(jscen, op, mults=_mults(jmm))
    for r, j in zip(mine, ref, strict=True):
        assert r["scenario"] == j["scenario"] and r["op"] == j["op"]
        assert r["differs"] == j["differs"]
        for w in ("cdp_winner", "total_winner"):
            a, b = r[w], j[w]
            assert set(a) == set(b)
            for k in a:
                assert a[k] == pytest.approx(b[k], rel=RTOL), (w, k)
        assert r["total_reduction"] == pytest.approx(
            j["total_reduction"], rel=1e-4, abs=1e-6)


def test_scenario_grids_equal():
    assert [dataclasses.astuple(s) for s in cd.scenario_grid()] == \
        [dataclasses.astuple(s) for s in jcd.scenario_grid()]
    assert [dataclasses.astuple(s) for s in cd.multi_die_scenarios(50.0)] \
        == [dataclasses.astuple(s) for s in jcd.multi_die_scenarios(50.0)]


@pytest.mark.parametrize("engine", ["numpy", "batched"])
def test_run_codesign_matches_reference(engine):
    kw = dict(mults=_mults(mm), engine=engine,
              batched_cfg=gb.BatchedGAConfig(pop_size=1024, generations=6))
    mine = cd.run_codesign("vgg16", 14, 30.0, 2.0, device=CPU, **kw)
    ref = jcd.run_codesign(
        "vgg16", 14, 30.0, 2.0, mults=_mults(jmm), engine=engine,
        batched_cfg=jgb.BatchedGAConfig(pop_size=1024, generations=6))
    assert _same(mine.exact, ref.exact)
    assert _same(mine.approx_only, ref.approx_only)
    if engine == "numpy":             # the same numpy RNG: the same run
        assert _same(mine, ref) and mine.summary() == ref.summary()
    assert _tied(mine.ga_cdp, ref.ga_cdp)
    assert mine.ga_reduction == ref.ga_reduction
    assert mine.ga_reduction > mine.approx_only_reduction > 0
    with pytest.raises(ValueError, match="engine"):
        cd.run_codesign("vgg16", 14, 30.0, 2.0, mults=_mults(mm),
                        engine="nope")


# --- calibration -------------------------------------------------------------

def test_delay_calibration_arithmetic():
    c = cal.DelayCalibration(400.0, 100.0, "macs/s", "gemm", "a", {"x": 1})
    j = jcal.DelayCalibration(400.0, 100.0, "macs/s", "gemm", "a", {"x": 1})
    assert c.scale == j.scale == 4.0
    assert c.calibrated_fps(30.0) == j.calibrated_fps(30.0) == 120.0
    assert c.calibrated_cdp(100.0, 50.0) == j.calibrated_cdp(100.0, 50.0)
    assert c.to_dict() == j.to_dict()
    assert dataclasses.astuple(cal.identity()) == \
        dataclasses.astuple(jcal.identity())
    assert cal.identity().calibrated_cdp(100.0, 50.0) == pytest.approx(2.0)
    assert cal.get_calibration("none") == cal.identity()
    with pytest.raises(ValueError, match="unknown calibration"):
        cal.get_calibration("nope")


def test_calibrate_gemm_cpu_records_the_plain_plan():
    c = cal.calibrate_gemm(m=32, k=48, n=32, reps=1, device=CPU)
    j = jcal.calibrate_gemm(m=32, k=48, n=32, reps=1)
    assert c.analytical == j.analytical
    assert c.source == "gemm" and c.unit == "macs/s" and c.anchor == j.anchor
    assert c.measured > 0 and c.scale > 0
    assert c.meta["dispatch"]["path"] == "xla"
    assert c.meta["backend"] == "cpu"
    assert c.meta["shape"] == j.meta["shape"] and c.meta["mult"] == "trunc2x2"
    assert c.calibrated_cdp(100.0, 50.0) == pytest.approx(2.0 / c.scale,
                                                          rel=1e-9)
    # the kernel plan, run through the wrappers' plain versions on the CPU
    for m, skinny in ((16, True), (128, False)):
        k = cal.calibrate_gemm(m=m, k=64, n=48, reps=1, policy="pallas",
                               mult_name="pareto:0.01" if skinny
                               else "trunc2x2", device=CPU)
        assert k.meta["dispatch"]["path"] == "fused"
        assert k.meta["dispatch"]["skinny"] is skinny


def test_calibrate_serving_cpu_and_its_analytical_mirror():
    c = cal.calibrate_serving(requests=2, gen=3, mult="trunc2x2",
                              kernel_policy="pallas", device=CPU)
    assert c.source == "serving" and c.unit == "tokens/s"
    assert c.measured > 0 and c.meta["decode_steps"] > 0
    assert c.meta["backend"] == "cpu" and c.meta["mult"] == "trunc2x2"
    # the reference's mirror of the same reduced config (its Engine cannot
    # serve on this JAX, so the analytical side is rebuilt from its modules)
    from repro import configs as jconfigs
    jcfg = jconfigs.apply_overrides(jconfigs.get_config("tinyllama-1.1b"),
                                    reduced=True)
    for n_dies in (1, 2):
        layers = []
        for i in range(jcfg.n_layers):
            layers += jwl.decode_block_gemms(
                f"cal.l{i}", jcfg.n_heads * jcfg.head_dim, jcfg.d_ff,
                jcfg.n_heads, jcfg.n_kv_heads, 8 + 1)
        want = jdf.layers_perf(layers, jacc.nvdla_default(2048, 7),
                               n_dies).fps
        got = cal.calibrate_serving(requests=1, gen=3, n_dies=n_dies,
                                    device=CPU)
        assert got.analytical == want and got.meta["kv_len"] == 9
        assert got.anchor.endswith(f"x {n_dies} dies")
    t1 = tg.HardwareTarget.monolithic(acc.nvdla_default(64, 7))
    assert cal.calibrate_serving(requests=1, gen=2, target=t1,
                                 device=CPU).meta["n_dies"] == 1
    with pytest.raises(ValueError, match="not both"):
        cal.calibrate_serving(target=t1, mesh_spec="model=1", device=CPU)
    t4 = tg.HardwareTarget(acc.nvdla_default(64, 7), 4,
                           (("data", 1), ("model", 4)))
    for kw in (dict(mesh_spec="model=4"), dict(target=t4),
               dict(mesh_spec="data=2")):
        with pytest.raises(NotImplementedError, match="item 2"):
            cal.calibrate_serving(device=CPU, **kw)


# --- the launcher and the accuracy module's proxy ------------------------------

def test_accuracy_module_reports_the_ga_proxy():
    assert acc_launch.proxy_accuracy_drop is ga.proxy_accuracy_drop
    assert acc_launch.ACC_DROP_NMED_COEF == ga.ACC_DROP_NMED_COEF
    assert acc_launch.ACC_DROP_MRED_COEF == ga.ACC_DROP_MRED_COEF


def test_launch_codesign_cpu_small(monkeypatch):
    """The reproduction's main path at a tiny size on the CPU: a few SGD
    steps, the fast library, a small population, two nodes."""
    monkeypatch.setattr(launch, "default_mults", lambda: _mults(mm))
    monkeypatch.setattr(launch, "NODES", (7, 28))
    res = launch.run(steps=3, device=CPU, pop=256, generations=3,
                     policy="pallas")
    assert set(res["drops"]) == {m.name for m in _mults(mm)}
    assert all(d >= 0 for d in res["drops"].values())
    assert res["drops"]["exact"] == 0.0
    for entry in res["nodes"]:
        rep = entry["report"]
        assert rep.ga_reduction > 0
        assert res["accuracy_fn"](mm.get_multiplier(
            rep.ga_cdp.config.multiplier)) <= launch.MAX_DROP
        assert entry["chosen_drop_pct"] <= launch.MAX_DROP
    a, b = res["refit"]
    feats = np.array([[m.stats.nmed, m.stats.mred] for m in _mults(mm)[1:]])
    drops = np.array([res["drops"][m.name] for m in _mults(mm)[1:]])
    coef = np.linalg.lstsq(feats, drops, rcond=None)[0]
    assert (a, b) == (max(float(coef[0]), 0.0), max(float(coef[1]), 0.0))
    lines = launch.format_lines(res)
    assert lines[0].startswith("exact top-1") and "refit" in lines[-1]
    assert sum("GA-CDP" in line for line in lines) == 2


def test_launch_default_mults_lists_each_name_once(monkeypatch):
    front = [mm.truncated(2, 0), mm.exact_multiplier()]
    monkeypatch.setattr(launch.pareto, "default_front", lambda: front)
    names = [m.name for m in launch.default_mults()]
    assert names[:2] == ["trunc2x0", "exact"]
    assert len(names) == len(set(names))
    assert set(names) >= set(mm.static_library())
