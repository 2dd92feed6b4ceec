"""Sharded training of repro_torch on torch.distributed, on the CPU under
gloo: worlds of 2 and 4 ranks started by `repro_torch.launch.mesh.spawn`
(tests/torch_train_ranks.py holds the rank programs), each world run
once per module and read by several tests.

The JAX package's mesh-bound train step fails on the installed JAX, so
the oracle is split:

  * `state_shardings` is held to the JAX package's, leaf by leaf, for
    every config at full size on abstract meshes (nothing allocated);
  * the sharded steps are held to the port's one-device `make_train_fns`
    (which tests/test_torch_train_step.py holds to the JAX package's):
    step-1 loss within rtol 1e-6 and gradient norm within 1e-5, every
    param within 1e-2 x lr, step 2 within 2e-4 (the reference test's
    own bound); at model=2 alone, bit for bit, the optimizer state too;
    under AdamW with f32, bf16 and int8 moments and under Adafactor (the
    last two update gathered whole moments);
  * one data=2 step is held directly to the JAX package's unsharded
    `make_train_fns` step from the same state.

The setup is the JAX package's sharded-step test
(tests/test_distributed.py): reduced TinyLlama with remat, 8 x 64 from
`synthetic.lm_batch`, two micro-batches, lr 1e-3.  The one-device runs
use one thread, as each rank does (the CPU's embedding backward sums in
another order over several threads).
"""

import functools
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_train_ranks as R
from repro import configs as jconfigs
from repro.compat import make_abstract_mesh as jmesh
from repro.data import synthetic as jsynthetic
from repro.train import train_step as jts
from repro_torch import configs
from repro_torch.launch import mesh as meshmod
from repro_torch.launch import train as launch
from repro_torch.sharding import rules
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import train_step as ts

#: a world's deadline; a hung rank fails its test within it
TIMEOUT_S = 240.0
MULTS = ("trunc2x2", "exact")
#: optimizers besides AdamW with f32 moments: bf16 moments update block
#: by block; int8 moments and Adafactor gather the moments whole, update
#: and keep the rank's block
OPTIMIZERS = ({"moment_dtype": "bf16"}, {"moment_dtype": "int8"},
              {"optimizer": "adafactor"})
#: (mult, StepOptions overrides) run in each world, by mesh spec
CASES = {
    "data=2": [("trunc2x2", {"fsdp": True}), ("exact", {"fsdp": True})],
    "model=2": [("trunc2x2", {}), ("exact", {})] +
               [("trunc2x2", o) for o in OPTIMIZERS],
    "model=2,data=2": [(m, {"fsdp": f}) for m in MULTS
                       for f in (True, False)] +
                      [("trunc2x2", {"fsdp": True, **o}) for o in OPTIMIZERS],
}
_CKPT = tempfile.mkdtemp(prefix="repro_train_sharded_")


def one_device(mult: str, kw: dict) -> dict:
    """The one-device run of a case: its mult and optimizer options (FSDP
    changes nothing on one device)."""
    return _one_device(mult, tuple(sorted(
        (k, v) for k, v in kw.items() if k != "fsdp")))


@functools.lru_cache(maxsize=None)
def _one_device(mult: str, kw: tuple) -> dict:
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return R.one_device_run(mult, **dict(kw))
    finally:
        torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def world(spec: str) -> list:
    ref = None
    if spec == "data=2":
        world("model=2,data=2")      # writes the checkpoint it restores
        ref = _reference_inputs()
    return meshmod.spawn(R.sharded_world, spec, device="cpu",
                         timeout_s=TIMEOUT_S,
                         args=(CASES[spec], _CKPT, ref))


# --- state specs against the JAX package ----------------------------------------

#: (moment dtype or "adafactor", fsdp) per variant; each config runs all
#: four on both meshes, fsdp flipped on the second
VARIANTS = (("f32", None), ("bf16", True), ("int8", False),
            ("adafactor", True))
SPEC_MESHES = (((16, 16), ("data", "model")),
               ((2, 16, 16), ("pod", "data", "model")))


def _options(mod, variant: str, fsdp):
    kw = {"optimizer": "adafactor"} if variant == "adafactor" else \
        {"moment_dtype": variant}
    return mod.StepOptions(fsdp=fsdp, **kw)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_state_shardings_equal_the_jax_packages(arch):
    """Every leaf of the train state (params, moments, int8 codes and
    scales, Adafactor's factors, step counters) gets the JAX package's
    spec, at full size: the reference through `eval_shape`, the port
    through its "meta" state."""
    jcfg, cfg = jconfigs.get_config(arch), configs.get_config(arch)
    for m, (sizes, names) in enumerate(SPEC_MESHES):
        jm, pm = jmesh(sizes, names), meshmod.make_abstract_mesh(sizes,
                                                                 names)
        for variant, fsdp in VARIANTS:
            if m and fsdp is not None:
                fsdp = not fsdp
            jo, po = _options(jts, variant, fsdp), _options(ts, variant,
                                                            fsdp)
            init, _ = jts.make_train_fns(jcfg, jo)
            want = {jax.tree_util.keystr(p): tuple(s.spec) for p, s in
                    jax.tree_util.tree_flatten_with_path(
                        jts.state_shardings(jcfg, jo, jm, init))[0]}
            got = dict(ckpt._named_leaves(ts.state_shardings(cfg, po, pm)))
            assert got == want, (arch, sizes, variant, fsdp, {
                k: (got.get(k), want.get(k)) for k in set(got) | set(want)
                if got.get(k) != want.get(k)})


def test_abstract_state_allocates_nothing():
    state = ts.abstract_state(configs.get_config("grok-1-314b"),
                              ts.StepOptions(moment_dtype="int8"))
    leaves = [t for _, t in ckpt._named_leaves(state)]
    assert leaves and all(t.device.type == "meta" for t in leaves)


# --- gradients through the column-parallel ops -------------------------------------

@pytest.mark.parametrize("op", ["exact_block", "exact_whole", "approx_block",
                                "bias_block", "approx_bias_block"])
def test_column_parallel_gradients_are_one_devices(op):
    """`gather_cols` of a block, the exact and the approximate GEMM run
    column-parallel and a split bias give every rank one device's loss
    and gradients, bit for bit."""
    one = R.grad_ops()[op]
    for rank in world("model=2"):
        got = rank["grads"][op]
        for k, want in one.items():
            if want is None:
                assert got[k] is None, (op, k)
            else:
                np.testing.assert_array_equal(got[k], want.numpy(),
                                              err_msg=f"{op} {k}")


def test_prefill_and_decode_builders_are_one_devices():
    """`make_prefill_step` / `make_decode_step` at model=2: the prefill's
    and two greedy decode steps' logits equal one device's, bit for bit
    (the column-parallel GEMMs and head-sharded attention of TP
    serving)."""
    want = R.serve_steps()["logits"]
    for rank in world("model=2"):
        for got, w in zip(rank["serve"]["logits"], want):
            np.testing.assert_array_equal(got, w.numpy())


# --- sharded steps against one device -------------------------------------------------

def _cases():
    return [(spec, i) for spec, cases in CASES.items()
            for i in range(len(cases))]


def _held(spec: str, i: int, bit: bool):
    mult, kw = CASES[spec][i]
    want = one_device(mult, kw)
    ranks = world(spec)
    for rank in ranks:
        got = rank["steps"][i]
        if bit:
            assert got["metrics"] == want["metrics"], (spec, mult, kw)
        (g1, g2), (w1, w2) = got["metrics"], want["metrics"]
        np.testing.assert_allclose(g1["loss"], w1["loss"], rtol=1e-6)
        np.testing.assert_allclose(g1["gnorm"], w1["gnorm"], rtol=1e-5)
        for key in ("loss", "gnorm"):
            np.testing.assert_allclose(g2[key], w2[key], rtol=2e-4)
        for name, t in ckpt._named_leaves(want["params"]):
            have = dict(ckpt._named_leaves(got["params"]))[name]
            gap = np.abs(have - t.numpy()).max()
            assert gap <= (0.0 if bit else 1e-2 * R.LR), (spec, name, gap)
        if bit:     # the moments too: int8 codes and scales, factors
            assert got["opt"].keys() == want["opt"].keys()
            for name, t in want["opt"].items():
                np.testing.assert_array_equal(got["opt"][name], t,
                                              err_msg=f"{spec} {kw} {name}")
    # every rank ends with the same whole params
    for rank in ranks[1:]:
        for name, t in ckpt._named_leaves(ranks[0]["steps"][i]["params"]):
            np.testing.assert_array_equal(
                dict(ckpt._named_leaves(rank["steps"][i]["params"]))[name],
                t)


@pytest.mark.parametrize("spec,i", _cases())
def test_sharded_steps_match_one_device(spec, i):
    _held(spec, i, bit=spec == "model=2")


@pytest.mark.parametrize("spec", list(CASES))
def test_each_rank_keeps_its_block(spec):
    """A rank's state leaves have the shapes of its block by the state
    specs over every axis (FSDP splits rows over data, the model axis
    columns)."""
    sizes = {"data": 1, "model": 1} | dict(meshmod.parse_spec(spec))
    mesh = meshmod.make_abstract_mesh(sizes.values(), sizes.keys())
    for i, (mult, kw) in enumerate(CASES[spec]):
        cfg, opts = R.config(mult), R.options(**kw)
        specs = dict(ckpt._named_leaves(ts.state_shardings(cfg, opts,
                                                           mesh)))
        whole = dict(ckpt._named_leaves(ts.abstract_state(cfg, opts)))
        want = {k: rules.local_shape(tuple(t.shape), specs[k], mesh,
                                     axes=mesh.axis_names)
                for k, t in whole.items()}
        got = world(spec)[0]["steps"][i]["shapes"]
        assert got == want
        if kw.get("fsdp") and mesh.axis_size("data") > 1:
            assert got["['params']['layers']['wq']"][-2] < \
                tuple(whole["['params']['layers']['wq']"].shape)[-2]


def test_model_axis_traffic_is_gathers_alone():
    """model=2 moves no gradient over a data axis: all-gathers only."""
    for rank in world("model=2"):
        calls = rank["steps"][0]["calls"]
        assert calls["all_gather"] > 0 and calls["all_reduce"] == 0


# --- the reference anchor ------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _reference_inputs():
    cfg = jconfigs.reduced(jconfigs.get_config("tinyllama-1.1b"),
                           remat=True, mult="trunc2x2", kernel_policy="xla")
    opts = jts.StepOptions(accum_steps=2, lr=R.LR, total_steps=50)
    init, step = jts.make_train_fns(cfg, opts)
    state = init(jax.random.key(0))
    bnp = jsynthetic.lm_batch(cfg.vocab, R.BATCH, R.SEQ, step=0)
    _, m = jax.jit(step)(state, {k: jnp.asarray(v) for k, v in bnp.items()})
    _reference_metrics[0] = {k: float(m[k]) for k in ("loss", "gnorm")}
    return jax.tree_util.tree_map(np.asarray, state), bnp


_reference_metrics: dict = {}


def test_data_parallel_step_matches_the_jax_package():
    """One data=2 step (two micro-batches, remat, trunc2x2) from the JAX
    package's own initial state, against its unsharded step."""
    _reference_inputs()
    want = _reference_metrics[0]
    for rank in world("data=2"):
        got = rank["reference"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["gnorm"], want["gnorm"], rtol=1e-5)


# --- elastic restore -------------------------------------------------------------

def test_elastic_restore_across_meshes():
    """Saved at model=2,data=2; restored at data=2 and on one device:
    every leaf bit-equal to the saved whole leaf, and the next step's
    loss within 2e-4 of each other."""
    saved = world("model=2,data=2")[0]["save"]["saved"]
    for rank in world("model=2,data=2")[1:]:
        for name, t in rank["save"]["saved"].items():
            np.testing.assert_array_equal(t, saved[name])
    nxt = []
    for rank in world("data=2"):
        r = rank["restore"]
        assert r["at"] == 1 and set(r["whole"]) == set(saved)
        for name, t in r["whole"].items():
            np.testing.assert_array_equal(t, saved[name], err_msg=name)
        nxt.append(r["next"]["loss"])
    cfg = R.config("trunc2x2")
    init, step = ts.make_train_fns(cfg, R.options(), R.CPU)
    mgr = ckpt.CheckpointManager(os.path.join(_CKPT, "elastic"))
    restored, at = mgr.restore(init(0))
    assert at == 1
    for name, t in ckpt._named_leaves(restored):
        np.testing.assert_array_equal(ckpt._to_numpy(t), saved[name])
    _, m = step(restored, R.batches(cfg)[1])
    np.testing.assert_allclose(nxt, m["loss"].item(), rtol=2e-4)


def test_cli_on_a_world_then_resumed_on_one_device(capsys):
    """`launch.train --mesh data=2` for 2 steps with checkpoints, then the
    CLI on one device resumes from its step 2 to step 3."""
    assert all(r["cli"]["rc"] == 0 for r in world("data=2"))
    where = os.path.join(_CKPT, "cli")
    assert ckpt.CheckpointManager(where).latest_step() == 2
    rc = launch.main(["--reduced", "--mult", "trunc2x2", "--kernel-policy",
                      "xla", "--steps", "3", "--batch", "4", "--seq", "32",
                      "--ckpt-dir", where, "--log-every", "1", "--device",
                      "cpu", "--mesh", "data=1"])
    out = capsys.readouterr().out
    assert rc == 0 and "resumed from step 2" in out and "step     2" in out
    assert ckpt.CheckpointManager(where).latest_step() == 3


def test_moe_under_a_data_axis_raises():
    assert "MoE config trains on the model axis only" in \
        world("data=2")[0]["moe"]


def test_fsdp_option_trains_on_one_device():
    """`StepOptions(fsdp=True)` is the one-device step on one device."""
    cfg = R.config("trunc2x2")
    b = R.batches(cfg)[0]
    got = {}
    for fsdp in (True, None):
        init, step = ts.make_train_fns(cfg, R.options(fsdp=fsdp), R.CPU)
        got[fsdp] = step(init(0), b)[1]["loss"].item()
    assert got[True] == got[None]
