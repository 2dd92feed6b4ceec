"""Tensor-parallel serving of repro_torch on torch.distributed, on the CPU
under gloo: worlds of 2 and 4 ranks started by
`repro_torch.launch.mesh.spawn` (tests/torch_tp_ranks.py holds the rank
programs), each world run once per module and read by several tests.

The oracle is split as the reference's own suite allows here (its
engines do not run on the installed JAX):

  * the TP GEMM is held to the port's one-device GEMM bit for bit, trunc2x2
    to the JAX package's `ops.approx_qgemm` (interpret mode) bit for bit,
    and the low-rank multiplier to it within rtol=1e-6, atol=1;
  * the engines under TP are held to the port's one-device engines on the
    same weights (which tests/test_torch_serving.py and friends hold to
    the JAX package): greedy tokens equal, prefill and decode logits
    equal, every rank's completions and non-timing stats equal; the paged
    engine to the slot engine on the same mesh, sampled rows included
    (tests/test_serving_paged.py::test_paged_tp_token_parity).
"""

import functools
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_tp_ranks as R
from repro.approx import gemm as jG
from repro.kernels import ops as jops
from repro_torch.launch import mesh as meshmod

MESHES = {"model=2": {"data": 1, "model": 2},
          "model=4": {"data": 1, "model": 4},
          "model=2,data=2": {"data": 2, "model": 2}}
#: a world's deadline; a hung rank fails its test within it
TIMEOUT_S = 240.0


@functools.lru_cache(maxsize=None)
def world(spec: str) -> list:
    fns = {"model=2": _two, "model=4": _four, "model=2,data=2": _grid}
    return meshmod.spawn(fns[spec], spec, device="cpu",
                         timeout_s=TIMEOUT_S)


@functools.lru_cache(maxsize=None)
def one_device(arch: str, mult: str) -> dict:
    cfg, params = R.model(arch, mult)
    return {"slot": R.serve(cfg, params),
            "paged": R.serve(cfg, params, paged=True, sampled=True),
            "logits": R.logits_run(cfg, params)}


def _two(mesh):
    return {"gemm": R.gemm_world(mesh), "engine": R.engine_world(mesh),
            "calibrate": R.calibrate_world(mesh)}


def _four(mesh):
    return {"gemm": R.gemm_world(mesh), "engine": R.engine_world(mesh)}


def _grid(mesh):
    return {"engine": R.engine_world(mesh, paged=True)}


def _same_on_every_rank(ranks: list, key) -> dict:
    first = ranks[0][key]
    for r in ranks[1:]:
        np.testing.assert_equal(r[key], first)
    return first


# --- (a) the TP GEMM ---------------------------------------------------------

@pytest.mark.parametrize("spec", ["model=2", "model=4"])
def test_tp_gemm_is_the_one_device_gemm_and_the_jax_kernel(spec):
    ranks = world(spec)
    got = _same_on_every_rank(ranks, "gemm")
    tp = MESHES[spec]["model"]
    for (mult, policy, m, k, n), out in got.items():
        a, b = R.operands(m, k, n)
        jspec = jG.spec_from_name(mult)
        ref = np.asarray(jops.approx_qgemm(jnp.asarray(a.numpy()),
                                           jnp.asarray(b.numpy()), jspec))
        if mult == "pareto:0.02:r2":
            np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1)
        else:
            np.testing.assert_array_equal(out, ref)
    shapes = {key[2:] for key in got}
    assert shapes == set(R.gemm_shapes())
    assert any(n % tp for _, _, n in shapes)   # the replicated branch ran


# --- (b) the slot engine ------------------------------------------------------

@pytest.mark.parametrize("case", R.ENGINE_CASES, ids="-".join)
@pytest.mark.parametrize("spec", list(MESHES))
def test_slot_engine_under_tp_equals_one_device(spec, case):
    ranks = world(spec)
    runs = [r["engine"][case] for r in ranks]
    slot = [run["slot"] for run in runs]
    for other in slot[1:]:
        assert other == slot[0]           # completions and stats, per rank
    one = one_device(*case)
    assert slot[0]["done"] == one["slot"]["done"]
    stats = slot[0]["stats"]
    assert stats["mesh"] == MESHES[spec]
    assert stats["evictions"]["length"] == 3
    want = {k: v for k, v in one["slot"]["stats"].items()}
    assert {k: v for k, v in stats.items() if k not in ("mesh", "tp")} == \
        want
    for run in runs:
        for got, ref in zip(run["logits"], one["logits"]):
            # every op is bit-identical on the CPU, the attention over the
            # rank's heads (decode_attention's einsums) included
            np.testing.assert_array_equal(got, ref)


def _gathers_per_layer(case, spec) -> int:
    arch, _ = case
    if arch == "mamba2-370m":
        return 2                    # in_proj, out_proj
    tp = MESHES[spec]["model"]
    # heads split where the model axis divides the 2 kv heads: the
    # attention output, wo, the SwiGLU product and w_down; else q, k and
    # v are gathered too
    return 4 if 2 % tp == 0 else 6


@pytest.mark.parametrize("case", R.ENGINE_CASES, ids="-".join)
@pytest.mark.parametrize("spec", list(MESHES))
def test_all_gathers_per_decode_step(spec, case):
    stats = world(spec)[0]["engine"][case]["slot"]["stats"]
    tp = stats["tp"]
    layers = 2
    assert tp["decode_all_gathers"] == stats["decode_steps"] * (
        layers * _gathers_per_layer(case, spec) + 1)


# --- (c) the paged engine -----------------------------------------------------

@pytest.mark.parametrize("case", R.ENGINE_CASES, ids="-".join)
def test_paged_engine_under_tp_equals_slot_engine_on_the_mesh(case):
    ranks = world("model=2,data=2")
    run = ranks[0]["engine"][case]
    for r in ranks[1:]:
        assert r["engine"][case]["paged"] == run["paged"]
    paged = _tokens(run["paged"])
    # token for token (speculation moves the ticks, not the tokens)
    assert paged == _tokens(run["slot_sampled"])
    st = run["paged"]["stats"]
    assert st["spec"]["acceptance_rate"] == 1.0
    assert st["mesh"] == MESHES["model=2,data=2"]
    one = _tokens(one_device(*case)["paged"])
    for rid in ("r0", "r2"):                  # the greedy rows
        assert paged[rid] == one[rid]
    # the sampled row draws from the same generator on equal logits
    assert paged["r1"] == one["r1"]


def _tokens(run: dict) -> dict:
    return {rid: c["tokens"] for rid, c in run["done"].items()}


# --- (d) calibration ----------------------------------------------------------

def test_calibrate_serving_on_a_model_axis_of_two():
    ranks = world("model=2")
    cals = [r["calibrate"] for r in ranks]
    for c in cals[1:]:
        assert c == cals[0]                    # every rank, the same value
    for name in ("spec", "target"):
        c = cals[0][name]
        assert c["source"] == "serving" and c["meta"]["n_dies"] == 2
        assert "x 2 dies" in c["anchor"]
        assert c["measured"] > 0 and c["analytical"] > 0 and c["scale"] > 0
        assert c["meta"]["engine"]["completed"] == 3
    served = cals[0]["target_engine"]
    assert served["stats"]["mesh"] == {"data": 1, "model": 2}
    assert served["done"] == one_device("tinyllama-1.1b",
                                        "trunc2x2")["slot"]["done"]


# --- (e) failure ----------------------------------------------------------------

def test_a_rank_that_raises_fails_the_world():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="(?s)rank 1 raised.*on purpose"):
        meshmod.spawn(R.failing_world, "model=2", device="cpu",
                      timeout_s=60.0)
    assert time.monotonic() - t0 < 60.0


def test_a_hung_rank_fails_within_the_deadline():
    t0 = time.monotonic()
    # rank 0 hangs (rank 1 may not have started either on a loaded host)
    with pytest.raises(RuntimeError, match=r"ranks \[0(, 1)?\] did not "
                                           r"finish within 3 s"):
        meshmod.spawn(R.hanging_world, "model=2", device="cpu",
                      timeout_s=3.0)
    assert time.monotonic() - t0 < 30.0


@pytest.mark.skipif(torch.cuda.is_available(), reason="the host has a card")
def test_spawn_defaults_to_the_card():
    # no device asked for: the card, which this host lacks, so the call
    # raises before any rank starts instead of running them on the CPU
    with pytest.raises(RuntimeError, match="runs on a CUDA device and "
                                           "none is available"):
        meshmod.spawn(R.failing_world, "model=2", timeout_s=10.0)
