"""Data-parallel serving of repro_torch on torch.distributed, on the CPU
under gloo: each data rank serves its own rows of the slot and paged
engines, and fleet replicas serve over a world of ranks.  Worlds of 2
and 4 ranks are started by `repro_torch.launch.mesh.spawn`
(tests/torch_dp_ranks.py holds the rank programs), each world run once
per module and read by several tests.

The oracle is split as in tests/test_torch_tp.py (the reference's
engines do not run on the installed JAX):

  * every cache, pool and per-slot leaf's spec is the JAX package's
    (`cache_pspec`, `paged_pool_pspec`, `batch_pspec` on abstract meshes,
    every config at full size), and the leaf the port allocates is its
    block by `rules.local_shape`;
  * the engines on a mesh are held to the port's one-device engines on
    the same weights (held to the JAX package elsewhere): tokens and
    ticks equal, every decode step's logits of a rank's rows bit-equal
    to the same rows of one device, the paged pools equal on every rank
    and to one device's; the fleet in a world to the same fleet in one
    process.
"""

import functools

import jax
import pytest
import torch

import torch_dp_ranks as R
from repro import configs as jconfigs
from repro.compat import make_abstract_mesh as jmesh
from repro.models import api as japi
from repro.sharding import rules as jrules
from repro_torch import configs
from repro_torch.launch import mesh as meshmod
from repro_torch.models import api
from repro_torch.serving.arena import PagedArena
from repro_torch.sharding import ctx, rules

# the one-device runs are tiny: more threads only contend (as the ranks,
# each on one thread)
torch.set_num_threads(1)

MESHES = {"data=2": {"data": 2, "model": 1},
          "model=2,data=2": {"data": 2, "model": 2}}
#: a world's deadline; a hung rank fails its test within it
TIMEOUT_S = 300.0
#: full-size shapes: a capacity every mesh's dp axes divide
CAP = 32
RULE_MESHES = [((2, 1), ("data", "model")), ((2, 4), ("data", "model")),
               ((16, 16), ("data", "model")),
               ((2, 16, 16), ("pod", "data", "model")),
               ((3, 2), ("data", "model"))]


@functools.lru_cache(maxsize=None)
def world(spec: str) -> list:
    fn = R.data_world if spec == "data=2" else R.grid_world
    return meshmod.spawn(fn, spec, device="cpu", timeout_s=TIMEOUT_S)


@functools.lru_cache(maxsize=None)
def one_device(arch: str, what: str = "slot", capacity: int = 4) -> dict:
    cfg, params = R.model(arch)
    if what == "slot":
        reqs = R.reference_trace(cfg.vocab) if capacity == 3 else None
        return R.serve(cfg, params, capacity=capacity, requests=reqs)
    return R.serve(cfg, params, paged=what)


def _same_on_every_rank(runs: list) -> dict:
    for run in runs[1:]:
        assert run["done"] == runs[0]["done"]
        assert run["stats"] == runs[0]["stats"]
    return runs[0]


# --- (a) the rules: every leaf's spec and its block -----------------------------

@functools.lru_cache(maxsize=None)
def _ref_cache(arch: str) -> dict:
    cfg = jconfigs.get_config(arch)
    tree = jax.eval_shape(lambda: japi.init_cache(cfg, CAP, 256))
    return {str(p[-1].key): tuple(leaf.shape)
            for p, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _split_axes(cfg, mesh) -> tuple:
    """The axes a port leaf splits over: the dp axes (a data rank's
    rows), and "model" for the `lm` family, whose attention runs on the
    rank's heads (the other families keep their caches' heads whole)."""
    return rules.dp_axes(mesh) + (("model",) if cfg.family == "lm" else ())


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_every_leaf_is_its_block_by_the_jax_rules(arch):
    """Slot caches, paged pools and dense leaves, lengths and the lanes'
    state: the spec is the JAX package's, the allocated leaf its block
    under `local_shape` (pools keep every page row)."""
    cfg = configs.get_config(arch)
    whole = _ref_cache(arch)
    meta = torch.device("meta")
    for shape, names in RULE_MESHES:
        jm, pm = jmesh(shape, names), meshmod.make_abstract_mesh(shape,
                                                                names)
        axes = _split_axes(cfg, pm)
        got = api.init_cache(cfg, CAP, 256, meta, mesh=pm, split_rows=True)
        assert set(got) == set(whole)
        for key, full in whole.items():
            spec = tuple(jrules.cache_pspec(key, full, jm))
            assert rules.cache_pspec(key, full, pm) == spec, key
            assert tuple(got[key].shape) == rules.local_shape(
                full, spec, pm, axes), (key, shape)
        rows = rules.local_rows(CAP, pm)
        state = {"length": (CAP,), "tok": (CAP, 1), "idle": (CAP,)}
        if cfg.cross_every:
            state["img"] = (CAP, cfg.n_img_tokens, cfg.d_model)
        for key, full in state.items():
            spec = tuple(jrules.batch_pspec(key, full, jm))
            assert rules.batch_pspec(key, full, pm) == spec
            assert rules.local_shape(full, spec, pm)[0] == rows
        dp = pm.axis_size("data") * pm.axis_size("pod")
        assert rows == (CAP // dp if CAP % dp == 0 else CAP)
        with ctx.use_rules(pm, rules.logical_rules(pm)):
            whole_arena = PagedArena(cfg, CAP, 256, 16, 513, meta)
            arena = PagedArena(cfg, CAP, 256, 16, 513, meta,
                               split_rows=True)
        assert arena.rows == rows and set(arena.paged) == \
            set(whole_arena.paged)
        for key, leaf in arena.cache.items():
            full = tuple(whole_arena.cache[key].shape)
            if key in arena.paged:
                spec = tuple(jrules.paged_pool_pspec(key, full, jm))
                assert rules.paged_pool_pspec(key, full, pm) == spec
                assert tuple(leaf.shape) == full   # the pool rule's block
            elif key == "length":
                assert tuple(leaf.shape) == (rows,)
            else:
                spec = tuple(jrules.cache_pspec(key, whole[key], jm))
                assert tuple(leaf.shape) == rules.local_shape(
                    whole[key], spec, pm, rules.dp_axes(pm)), key


def test_local_shape_splits_the_axes_it_is_given():
    pm = meshmod.make_abstract_mesh((2, 4), ("data", "model"))
    spec = ("data", None, "model")
    assert rules.local_shape((8, 3, 16), spec, pm) == (4, 3, 4)
    assert rules.local_shape((8, 3, 16), spec, pm, ("model",)) == (8, 3, 4)
    assert rules.local_shape((8, 3, 16), spec, pm, ("data",)) == (4, 3, 16)
    assert rules.local_rows(8, pm) == 4 and rules.local_rows(6, pm) == 3
    assert rules.local_rows(5, pm) == 5


def test_a_ranks_rows_run_at_one_devices_shapes():
    """Inside `ctx.whole_rows` the norms and decode attention see the
    whole row count, the rank's rows at their offset (on the card the
    kernels' split depends on it), and return the rank's rows."""
    from repro_torch.models import common as C
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((4, 1, 16), generator=gen)
    w = torch.randn((16,), generator=gen)
    seen = []

    def fn(a, b):
        seen.append((tuple(a.shape), a[:2].abs().sum().item()))
        return a * 2 + b

    with ctx.whole_rows(2, 4):
        got = C.on_whole_rows(fn, x[2:], x[2:])
        norm = C.rmsnorm(x[2:], w)
        ln = C.layernorm(x[2:], w, w)
    assert seen == [((4, 1, 16), 0.0)]            # zero rows before them
    assert torch.equal(got, fn(x, x)[2:])
    assert torch.equal(norm, C.rmsnorm(x, w)[2:])
    assert torch.equal(ln, C.layernorm(x, w, w)[2:])
    assert C.on_whole_rows(fn, x, x).shape == x.shape  # outside: as given


# --- (b) the slot engine ---------------------------------------------------------

def _rank_rows(run: dict, rank: int, spec: str) -> tuple[int, int]:
    mesh = meshmod.Mesh(tuple(meshmod.parse_spec(spec)), rank=rank)
    lo, n = run["rows"]
    assert n == 4 // mesh.axis_size("data")
    assert lo == mesh.axis_index("data") * n
    return lo, n


@pytest.mark.parametrize("arch", R.SLOT_ARCHS)
@pytest.mark.parametrize("spec", list(MESHES))
def test_slot_engine_splits_its_rows_and_equals_one_device(spec, arch):
    runs = [r["slot"][arch] for r in world(spec)]
    run = _same_on_every_rank(runs)
    one = one_device(arch)
    assert run["done"] == one["done"]
    stats = run["stats"]
    assert stats["mesh"] == MESHES[spec]
    assert {k: v for k, v in stats.items() if k not in ("mesh", "tp")} == \
        one["stats"]
    data = stats["tp"]["data"]
    # one all-gather of the sampled tokens per decode step, nothing else
    assert data["decode_all_gathers"] == stats["decode_steps"] > 0
    assert data["all_gathers"] == data["decode_all_gathers"]
    assert stats["tp"]["rows_per_rank"] == 2
    for rank, r in enumerate(runs):
        lo, n = _rank_rows(r, rank, spec)
        assert r["lanes"] == {"tok": (n, 1), "idle": (n,)}
        assert r["shapes"]["length"] == (n,)
        mesh = meshmod.make_abstract_mesh(MESHES[spec].values(),
                                          MESHES[spec].keys())
        cfg = configs.reduced(configs.get_config(arch))
        for key, full in one["shapes"].items():
            if key != "length":
                assert r["shapes"][key] == rules.local_shape(
                    full, rules.cache_pspec(key, full, mesh), mesh,
                    _split_axes(cfg, mesh)), key
        # every decode step's logits of the rank's rows, to the bit
        assert len(r["logits"]) == len(one["logits"])
        for got, want in zip(r["logits"], one["logits"]):
            assert (got == want[lo:lo + n]).all()


@pytest.mark.parametrize("spec", list(MESHES))
def test_capacity_three_keeps_its_rows_whole(spec):
    """The reference's case (tests/test_distributed.py:141): three rows
    do not divide two data ranks, so every rank holds every row."""
    run = _same_on_every_rank([r["slot"]["capacity3"] for r in world(spec)])
    one = one_device("tinyllama-1.1b", capacity=3)
    assert run["done"] == one["done"]
    assert run["rows"] == (0, 3) and run["shapes"]["length"] == (3,)
    stats = run["stats"]
    assert stats["mesh"] == MESHES[spec]
    assert stats["evictions"]["length"] == 3
    assert stats["tp"]["rows_per_rank"] == 3
    assert stats["tp"]["data"]["all_gathers"] == 0
    assert all((g == w).all() for g, w in zip(run["logits"],
                                              one["logits"]))


def test_moe_keeps_its_rows_whole():
    """Capacity couples an MoE call's rows, so the rows stay whole under
    a data axis and the tokens are one device's."""
    run = _same_on_every_rank([r["moe"] for r in world("data=2")])
    cfg, params = R.model("grok-1-314b")
    one = R.serve(cfg, params)
    assert run["done"] == one["done"]
    assert run["rows"] == (0, 4) and run["lanes"]["tok"] == (4, 1)
    assert run["stats"]["tp"]["data"]["all_gathers"] == 0


# --- (c) the paged engine --------------------------------------------------------

@pytest.mark.parametrize("name", list(R.PAGED_RUNS))
def test_paged_engine_splits_its_rows(name):
    ranks = world("data=2")
    runs = [r["paged"][name] for r in ranks]
    run = _same_on_every_rank(runs)
    one = one_device("tinyllama-1.1b", name)
    assert run["done"] == one["done"]
    stats = run["stats"]
    assert {k: v for k, v in stats.items() if k not in ("mesh", "tp")} == \
        one["stats"]
    if name != "PC":
        # P and PS: the slot engine's tokens on the same mesh
        slot = ranks[0]["paged"]["S4"]["done"]
        assert {k: c["tokens"] for k, c in run["done"].items()} == \
            {k: c["tokens"] for k, c in slot.items()}
    if name != "PC":
        # r2 reads r0's pages (chunked, r0 registers its prompt only
        # after r2's admission)
        assert stats["paged"]["prefix_hits"] >= 1
    if name == "PS":
        assert stats["spec"]["acceptance_rate"] == 1.0
    for rank, r in enumerate(runs):
        lo, n = _rank_rows(r, rank, "data=2")
        assert r["table"][0] == n and r["shapes"]["length"] == (n,)
        assert r["shapes"]["k"] == one["shapes"]["k"]  # pools: every page
        # the pools equal on every rank, and to one device's
        assert r["pools"] == one["pools"]
    data = stats["tp"]["data"]
    assert data["decode_all_gathers"] > 0


# --- (d) calibration, the fleet and the CLIs ----------------------------------

def test_calibrate_serving_on_a_data_axis():
    cals = [r["calibrate"] for r in world("data=2")]
    for c in cals[1:]:
        assert c == cals[0]                    # every rank, the same value
    c = cals[0]
    assert c["n_dies"] == 1 and "x 1 dies" in c["anchor"]
    assert c["measured"] > 0 and c["analytical"] > 0 and c["scale"] > 0
    from repro_torch.core import calibrate as cal
    one = cal.calibrate_serving(requests=2, capacity=2, max_len=32,
                                prompt=6, gen=3, device="cpu")
    assert c["decode_steps"] == one.meta["decode_steps"]
    assert c["decode_tokens"] == one.meta["decode_tokens"]


def test_fleet_over_a_world_decides_as_one_process():
    """A one-die replica (data-parallel over the world) and a two-die one
    (tensor-parallel), replica us-west killed and restarted over its
    mesh: every rank decides what the same fleet decides in one
    process, token for token."""
    runs = [r["fleet"] for r in world("data=2")]
    one = R.fleet_run()
    timed = ("joules", "joules_max", "meshes", "rows")
    for run in runs:
        assert {k: v for k, v in run.items() if k not in timed} == \
            {k: v for k, v in one.items() if k not in timed}
        assert run["meshes"] == [{"data": 2, "model": 1},
                                 {"data": 1, "model": 2}]
        assert run["rows"] == [1, 2]
        assert run["joules_max"] == runs[0]["joules_max"]
        assert all(m >= j > 0 for m, j in zip(run["joules_max"],
                                              run["joules"]))
    assert one["restarts"] == [1, 0] and one["recoveries"]
    assert one["requeue_events"] and not one["lost"]


def test_serve_and_fleet_clis_on_a_data_axis():
    ranks = world("data=2")
    for rank, r in enumerate(ranks):
        (rc, out), (frc, fout) = r["cli"]["serve"], r["cli"]["fleet"]
        assert rc == 0 and frc == 0
        if rank:
            assert out == fout == ""           # only rank 0 prints
    out, fout = ranks[0]["cli"]["serve"][1], ranks[0]["cli"]["fleet"][1]
    assert "mesh={'data': 2, 'model': 1}" in out
    assert "data axes 1.0" in out and "2 of 4 slots per rank" in out
    assert "lost=0 (ZERO-LOST OK)" in fout
    assert "mesh {'data': 2, 'model': 1}" in fout
