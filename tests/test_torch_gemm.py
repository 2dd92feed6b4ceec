"""repro_torch's quantization, MultSpec compilation, approximate GEMM,
weight-plane cache and dispatch policy against the JAX package.

Inputs come from numpy with a fixed seed and go to both packages.  The
JAX side runs jitted, which is how it serves: XLA compiles the quantizer's
`/ 127` into a multiply by f32(1/127), and the port computes the scale
that way (eager JAX divides instead and differs by one ulp on some rows).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.approx import gemm as JG
from repro.approx import quant as JQ
from repro.core import multipliers as jmm
from repro.core import netlist as jnl
from repro_torch.approx import gemm as G
from repro_torch.approx import layers as L
from repro_torch.approx import quant as Q
from repro_torch.core import lut as lutmod
from repro_torch.core import multipliers as mm
from repro_torch.kernels import approx_qgemm as qk
from repro_torch.kernels import dispatch, ops

RNG = np.random.default_rng(5)

# Pin torch's CPU pool: the test workers share the cores, and a fixed
# thread count keeps the order of CPU reductions the same everywhere.
torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _mask(seed):
    return np.random.default_rng(seed).random(
        len(jnl.bw8().prunable_gates())) < 0.03


def _lowrank_pair(rank, seed=1):
    m = _mask(seed)
    return (JG.from_multiplier(jmm.pruned(m, name=f"tg_{seed}"), rank=rank),
            G.from_multiplier(mm.pruned(m, name=f"tg_{seed}"), rank=rank))


# --- core copies / spec compilation -------------------------------------------

@pytest.mark.parametrize("name", ["exact", "trunc2x2", "trunc3x1",
                                  "trunc4x4"])
def test_library_luts_and_specs_match(name):
    jm, tm = jmm.get_multiplier(name), mm.get_multiplier(name)
    np.testing.assert_array_equal(tm.lut, jm.lut)
    assert tm.area_nand2eq == jm.area_nand2eq
    assert tm.stats.as_dict() == jm.stats.as_dict()
    js, ts = JG.spec_from_name(name), G.spec_from_name(name)
    assert (ts.mode, ts.trunc_a, ts.trunc_b, ts.rank, ts.nmed) == \
        (js.mode, js.trunc_a, js.trunc_b, js.rank, js.nmed)


@pytest.mark.parametrize("rank", [1, 2, 8])
def test_lowrank_spec_tables_match(rank):
    js, ts = _lowrank_pair(rank, seed=3)
    assert ts.mode == js.mode == "lowrank" and ts.rank == js.rank
    np.testing.assert_array_equal(ts.fu_q.numpy(), np.asarray(js.fu_q))
    np.testing.assert_array_equal(ts.fv_q.numpy(), np.asarray(js.fv_q))
    np.testing.assert_array_equal(ts.s_r.numpy(), np.asarray(js.s_r))
    assert ts.residual_nmed == js.residual_nmed


def test_rank_suffix_and_pareto_names(monkeypatch, tmp_path):
    """"pareto:<band>" resolves through each package's own NSGA-II front
    and disk cache.  Both fronts are cut to pop 8 x 3 generations here (the
    default 56 x 44 costs ~15 s a package), each cached in its own temporary
    directory, so neither package can read the other's file."""
    assert G.spec_from_name("trunc2x2:r3").mode == "trunc"
    assert G.spec_from_name("exact").is_exact
    with pytest.raises(KeyError):
        G.spec_from_name("nope")
    assert lutmod.effective_rank(mm.truncated(2, 2).lut) >= 1

    from repro.core import pareto as jpareto
    from repro_torch.core import pareto
    small = dict(pop_size=8, generations=3, seed=0)
    j_front, t_front = jpareto.default_front, pareto.default_front
    monkeypatch.setattr(jpareto, "_CACHE_DIR", tmp_path / "jax")
    monkeypatch.setattr(jpareto, "default_front", lambda: j_front(**small))
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path / "torch"))
    monkeypatch.setattr(pareto, "default_front", lambda: t_front(**small))
    t_front.cache_clear()
    js = JG.spec_from_name("pareto:0.02:r2")
    ts = G.spec_from_name("pareto:0.02:r2")
    assert (tmp_path / "torch" / "torch_nsga_front_p8_g3_s0.json").exists()
    assert ts.name == js.name and ts.mode == js.mode == "lowrank"
    assert ts.rank == js.rank == 2 and ts.nmed == js.nmed
    np.testing.assert_array_equal(ts.fu_q.numpy(), np.asarray(js.fu_q))
    np.testing.assert_array_equal(ts.fv_q.numpy(), np.asarray(js.fv_q))
    np.testing.assert_array_equal(ts.s_r.numpy(), np.asarray(js.s_r))
    # a second process would read the front back from its disk cache
    t_front.cache_clear()
    assert [m.name for m in pareto.default_front()] == \
        [m.name for m in jpareto.default_front()]
    t_front.cache_clear()


# --- quantization ------------------------------------------------------------

@pytest.mark.parametrize("axis", [None, 0, 1, (0, 2)])
def test_quantize_bitexact_with_compiled_jax(axis):
    shape = (3, 40, 24) if axis == (0, 2) else (40, 24)
    x = RNG.standard_normal(shape).astype(np.float32)
    qj, sj = jax.jit(lambda v: JQ.quantize(v, axis))(jnp.asarray(x))
    qt, st = Q.quantize(_t(x), axis)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_allclose(Q.dequantize(qt, st).numpy(), x,
                               atol=float(st.max()) * 0.5 + 1e-7)


def test_qweight_leaves():
    w = {"q": torch.ones((2, 2), dtype=torch.int8),
         "s": torch.full((1, 2), 0.5)}
    assert Q.is_qweight(w) and not Q.is_qweight({"q": 1})
    assert torch.equal(Q.dequantize_weight(w, torch.float32),
                       torch.full((2, 2), 0.5))
    assert Q.leaf_name(("layers", "wq")) == "wq" and Q.leaf_name(()) == ""


# --- approximate matmul --------------------------------------------------------

SPECS = ["trunc2x2", "trunc3x1", "lowrank2", "lowrank4"]


def _specs(name):
    if name.startswith("lowrank"):
        return _lowrank_pair(int(name[-1]), seed=int(name[-1]))
    return JG.spec_from_name(name), G.spec_from_name(name)


@pytest.mark.parametrize("policy", ["xla", "pallas"])
@pytest.mark.parametrize("name", SPECS)
def test_approx_matmul_matches_jax(name, policy):
    """Fresh-quantize approximate matmul, both packages on the same
    numbers.  Integer paths are bit-exact; low-rank flushes in the same
    order, within f32 rounding of XLA's (rtol=1e-6)."""
    js, ts = _specs(name)
    js, ts = js.with_policy(policy), ts.with_policy(policy)
    x = RNG.standard_normal((37, 64)).astype(np.float32)
    w = RNG.standard_normal((64, 48)).astype(np.float32)
    want = np.asarray(jax.jit(lambda a, b: JG.approx_matmul(a, b, js))(
        jnp.asarray(x), jnp.asarray(w)))
    got = G.approx_matmul(_t(x), _t(w), ts).numpy()
    if name.startswith("trunc"):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("policy", ["xla", "pallas"])
@pytest.mark.parametrize("name", SPECS)
def test_prepared_matches_fresh_bitexact(name, policy):
    """The weight-plane cache is a recomputation saving, not an
    approximation (mirrors tests/test_weight_cache.py)."""
    _, spec = _specs(name)
    spec = spec.with_policy(policy)
    x = _t(RNG.standard_normal((37, 64)).astype(np.float32))
    w = _t(RNG.standard_normal((64, 48)).astype(np.float32))
    fresh = G.approx_matmul(x, w, spec)
    pw = G.prepare_weight(w, spec)
    assert (pw.planes.shape[0] == 0) == (policy == "pallas")
    assert torch.equal(G.approx_matmul_prepared(x, pw, spec), fresh)
    assert torch.equal(L.gemm(x, pw, spec), fresh)
    assert torch.equal(L.gemm(x, w, spec), fresh)


def test_prepared_stacked_leaf_slices_like_raw():
    _, spec = _lowrank_pair(2, seed=2)
    w = _t(RNG.standard_normal((3, 32, 16)).astype(np.float32))
    pw = G.prepare_weight(w, spec)
    for i in range(3):
        pw_i = G.prepare_weight(w[i], spec)
        layer = pw.layer(i)
        assert torch.equal(layer.wq, pw_i.wq)
        assert torch.equal(layer.sw, pw_i.sw)
        assert torch.equal(layer.planes, pw_i.planes)


def test_prepared_rejects_other_spec_and_differentiation():
    ts = G.spec_from_name("trunc2x2")
    pw = G.prepare_weight(_t(RNG.standard_normal((16, 8)).astype(np.float32)),
                          ts)
    with pytest.raises(ValueError, match="re-run prepare_weight"):
        G.approx_matmul_prepared(torch.ones((2, 16)), pw,
                                 G.spec_from_name("trunc3x1"))
    x = torch.ones((2, 16), requires_grad=True)
    y = G.approx_matmul_prepared(x, pw, ts)
    with pytest.raises(NotImplementedError, match="serving-time"):
        y.sum().backward()
    assert G.prepare_weight(pw.w, None) is pw.w


def test_approx_matmul_straight_through_grads_match_jax():
    js, ts = _specs("trunc2x2")
    x = RNG.standard_normal((5, 16)).astype(np.float32)
    w = RNG.standard_normal((16, 8)).astype(np.float32)
    g = RNG.standard_normal((5, 8)).astype(np.float32)
    gj = jax.grad(lambda a, b: jnp.sum(JG.approx_matmul(a, b, js) *
                                       jnp.asarray(g)), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    xt, wt = _t(x).requires_grad_(), _t(w).requires_grad_()
    (G.approx_matmul(xt, wt, ts) * _t(g)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gj[0]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gj[1]),
                               rtol=1e-5, atol=1e-5)


def test_exact_gemm_is_a_float_matmul():
    x = _t(RNG.standard_normal((4, 8)).astype(np.float32))
    w = _t(RNG.standard_normal((8, 3)).astype(np.float32))
    torch.testing.assert_close(L.gemm(x, w, None), x @ w)
    torch.testing.assert_close(L.dense(x, w, torch.ones(3), G.exact_spec()),
                               x @ w + 1)


# --- dispatch ------------------------------------------------------------------

def test_policy_resolution(monkeypatch):
    monkeypatch.delenv("REPRO_KERNEL_POLICY", raising=False)
    assert dispatch.resolve(None) == "auto"
    assert dispatch.resolve("PALLAS") == "pallas"
    with pytest.raises(ValueError, match="unknown kernel policy"):
        dispatch.resolve("triton")
    monkeypatch.setenv("REPRO_KERNEL_POLICY", "xla")
    assert dispatch.resolve("auto") == "xla"
    assert G.spec_from_name("trunc2x2").with_policy(None).policy == "xla"


def test_gemm_plan_by_policy_and_device(monkeypatch):
    monkeypatch.delenv("REPRO_KERNEL_POLICY", raising=False)
    # "auto" on a CUDA tensor looks the tuning cache up under the card's
    # name and SM count: stand in an H100's
    from repro_torch import device as D
    monkeypatch.setattr(D, "_props", lambda index: ("NVIDIA H100", 132))
    plan = dispatch.choose_gemm_path("pallas", m=4, k=2048, n=5632,
                                     device="cpu")
    assert plan.use_pallas and plan.skinny and plan.bm == 4
    plan = dispatch.choose_gemm_path("pallas", m=128, k=2048, n=5632)
    assert plan.path == "fused" and not plan.skinny
    # padding multiples are the CUDA kernels' own tiles, no more
    assert (plan.bm, plan.bk, plan.bn) == qk.PLANE0_TILE == (64, 64, 64)
    plan = dispatch.choose_gemm_path("pallas", m=4, k=2049, n=300)
    assert (plan.bk, plan.bn) == qk.SKINNY_TILE == (16, 1)
    assert dispatch.choose_gemm_path("pallas", m=33, k=8, n=8).bm == 64
    assert not dispatch.choose_gemm_path("xla", m=4, k=8, n=8,
                                         device="cuda").use_pallas
    assert not dispatch.choose_gemm_path("auto", m=4, k=8, n=8,
                                         device="cpu").use_pallas
    assert dispatch.choose_gemm_path("auto", m=4, k=8, n=8,
                                     device="cuda").use_pallas
    assert dispatch.use_pallas_attention("auto", "cuda")
    assert not dispatch.use_pallas_attention("auto", "cpu")


def test_lowrank_prefill_gemm_is_not_ported_on_the_card():
    """m > SKINNY_MAX_M with a low-rank spec reaches the fused kernel's
    wrapper (fused=False the stacked one), which raises on a device other
    than CUDA instead of falling back; on the CPU it runs the plain
    planes.  (The name predates the fused kernel's port.)"""
    _, spec = _lowrank_pair(2, seed=2)
    a = torch.empty((64, 128), dtype=torch.int8, device="meta")
    b = torch.empty((128, 128), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="approx_qgemm_fused"):
        ops.approx_qgemm(a, b, spec)
    with pytest.raises(ValueError, match="approx_qgemm_stacked"):
        ops.approx_qgemm(a, b, spec, fused=False)
    a = _t(RNG.integers(-128, 128, (64, 100)).astype(np.int8))
    b = _t(RNG.integers(-128, 128, (100, 40)).astype(np.int8))
    assert torch.equal(ops.approx_qgemm(a, b, spec),
                       G.approx_qgemm(a, b, spec))
