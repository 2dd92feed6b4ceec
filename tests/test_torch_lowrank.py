"""repro_torch's low-rank GEMM kernels and its Pareto-front fork against the
JAX package.

On the CPU the fused and stacked wrappers run their plain PyTorch
versions; the JAX kernels run as the JAX package's own tests run them
(interpret mode, through `repro.kernels.ops`).  The stacked planes and the
integer products are exact on both sides, so the stacked kernels agree bit
for bit; the port's fused plain version is bit-identical to its stacked
one and to the skinny one.  Against the JAX fused kernel the port is held
within the contract of `tests/test_kernels.py`, rtol=1e-6, atol=1: XLA
contracts the JAX kernels' flush `acc + s_r * acc_r` into fused
multiply-adds from the second correction plane on, the port rounds every
product and sum separately, and at ranks >= 2 up to a third of the
outputs differ by one rounding of a partial sum (ROADMAP Queue 3).  The
tests pin that this contraction is the whole difference.

The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.approx import gemm as JG
from repro.core import multipliers as jmm
from repro.core import netlist as jnl
from repro.core import pareto as jpareto
from repro.kernels import approx_qgemm as jqk
from repro.kernels import ops as jops
from repro_torch.approx import gemm as G
from repro_torch.core import multipliers as mm
from repro_torch.core import pareto
from repro_torch.kernels import approx_qgemm as qk
from repro_torch.kernels import dispatch, ops, qgemm

RNG = np.random.default_rng(12)

# Pin torch's CPU pool: the test workers share the cores, and a fixed
# thread count keeps the order of CPU reductions the same everywhere.
torch.set_num_threads(1)


def _rand_q(shape):
    return RNG.integers(-128, 128, shape).astype(np.int8)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _lowrank_pair(rank, seed):
    """The same pruned multiplier compiled by both packages."""
    mask = np.random.default_rng(seed).random(
        len(jnl.bw8().prunable_gates())) < 0.03
    return (JG.from_multiplier(jmm.pruned(mask, name=f"tl_{seed}"),
                               rank=rank),
            G.from_multiplier(mm.pruned(mask, name=f"tl_{seed}"), rank=rank))


def _fma_flush(a, b, tspec):
    """The port's integer planes flushed the way XLA compiles the JAX
    kernels' flush on the CPU (found by trying every per-plane pattern):
    0 + 1 * acc_0 folds to acc_0, plane 1 is added with the product and the
    sum rounded separately, as the port does, and every later plane as one
    fused multiply-add, out = fma(s_r, f32(acc_r), out) (emulated in
    float64, which holds s_r * f32(acc_r) exactly)."""
    a_s, b_s, scales = ops.build_stacks(_t(a), _t(b), tspec)
    s = scales[:, 0].numpy()
    accs = [G.qgemm_int32(a_s[p], b_s[p]).numpy().astype(np.float32)
            for p in range(a_s.shape[0])]
    out = accs[0]
    for p in range(1, len(accs)):
        if p == 1:
            out = out + s[p] * accs[p]
        else:
            out = (out.astype(np.float64) + np.float64(s[p])
                   * accs[p].astype(np.float64)).astype(np.float32)
    return out


# --- fused / stacked plain versions vs the JAX kernels -----------------------

GEMM_SHAPES = [(8, 16, 8), (64, 96, 80), (128, 128, 128), (100, 130, 50),
               (1, 256, 257), (300, 64, 512)]
# VGG16 im2col GEMMs (conv 1 and conv 2's K and N) cut to M = 256
VGG_SHAPES = [(256, 27, 64), (256, 576, 64)]


@pytest.mark.parametrize("rank", [1, 2, 4, 8])
@pytest.mark.parametrize("shape", GEMM_SHAPES + VGG_SHAPES)
def test_fused_plain_matches_jax_fused_kernel(shape, rank):
    """ops.approx_qgemm on CPU tensors reaches the fused wrapper's plain
    version (the skinny one at m <= 32); JAX runs its fused kernel in
    interpret mode.  Both flush the same planes in the same order."""
    m, k, n = shape
    a, b = _rand_q((m, k)), _rand_q((k, n))
    jspec, tspec = _lowrank_pair(rank, seed=rank)
    got = ops.approx_qgemm(_t(a), _t(b), tspec).numpy()
    want = np.asarray(jops.approx_qgemm(jnp.asarray(a), jnp.asarray(b),
                                        jspec))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1.0)
    np.testing.assert_array_equal(_fma_flush(a, b, tspec), want)
    # the fused, stacked and skinny plain versions are one function
    stacked = ops.approx_qgemm(_t(a), _t(b), tspec, fused=False).numpy()
    np.testing.assert_array_equal(got, stacked)
    if m <= qk.SKINNY_MAX_M:
        sk = ops.approx_qgemm(_t(a), _t(b), tspec, skinny=True).numpy()
        np.testing.assert_array_equal(got, sk)


@pytest.mark.parametrize("spec_name", ["trunc2x2", "lowrank2", "lowrank8"])
@pytest.mark.parametrize("shape", [(64, 96, 80), (100, 130, 50),
                                   (256, 27, 64)])
def test_stacked_plain_matches_jax_stacked_kernel(shape, spec_name):
    """build_stacks against JAX's, bit for bit; the stacked plain version
    against JAX's stacked kernel, whose flush XLA contracts as well."""
    m, k, n = shape
    a, b = _rand_q((m, k)), _rand_q((k, n))
    if spec_name.startswith("lowrank"):
        jspec, tspec = _lowrank_pair(int(spec_name[7:]), seed=3)
    else:
        jspec, tspec = (JG.spec_from_name(spec_name),
                        G.spec_from_name(spec_name))
    ja, jb, js = jops.build_stacks(jnp.asarray(a), jnp.asarray(b), jspec)
    ta, tb, ts = ops.build_stacks(_t(a), _t(b), tspec)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    got = ops.approx_qgemm(_t(a), _t(b), tspec, fused=False).numpy()
    want = np.asarray(jops.approx_qgemm(jnp.asarray(a), jnp.asarray(b),
                                        jspec, fused=False))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1.0)
    np.testing.assert_array_equal(_fma_flush(a, b, tspec), want)


def test_fused_plain_masks_fully_padded_k_tile():
    """k_valid < K by a whole K tile: pad zeros map to tbl[0] != 0, so the
    mapped A must be zeroed past k_valid (tests/test_kernels.py:167)."""
    jspec, tspec = _lowrank_pair(2, seed=9)
    a, b = _rand_q((128, 128)), _rand_q((128, 128))
    ap = np.zeros((128, 256), np.int8)
    ap[:, :128] = a
    bp = np.zeros((256, 128), np.int8)
    bp[:128] = b
    got = qgemm.approx_qgemm_fused(
        _t(ap), _t(bp), tspec.fu_q, tspec.fv_q,
        ops.plane_scales(tspec, 2, "cpu"), k_valid=128).numpy()
    scales = jnp.concatenate([jnp.ones((1,), jnp.float32),
                              -jspec.s_r])[:, None]
    want = np.asarray(jqk.approx_qgemm_fused(
        jnp.asarray(ap), jnp.asarray(bp), jspec.fu_q, jspec.fv_q, scales,
        k_valid=128, bm=128, bk=128, bn=128, interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1.0)
    np.testing.assert_array_equal(_fma_flush(a, b, tspec), want)
    np.testing.assert_array_equal(
        got, G.approx_qgemm(_t(a), _t(b), tspec).numpy())


# --- routing and checks ------------------------------------------------------

def test_tiled_kernels_pad_to_their_own_tiles():
    assert qk.choose_blocks(300, 27, 64, kernel="fused") == qk.FUSED_TILE
    assert qk.choose_blocks(300, 27, 64, kernel="stacked") == \
        qk.STACKED_TILE
    plan = dispatch.choose_gemm_path("pallas", m=300, k=27, n=64, rank=5)
    assert plan.path == "fused" and (plan.bm, plan.bk, plan.bn) == \
        qk.FUSED_TILE
    assert (plan.bm, plan.bk, plan.bn) == qk.choose_blocks(
        300, 27, 64, kernel="fused")
    plan = dispatch.choose_gemm_path("pallas", m=300, k=27, n=64)
    assert plan.path == "fused" and (plan.bm, plan.bk, plan.bn) == \
        qk.choose_blocks(300, 27, 64, kernel="plane0")
    assert dispatch.choose_gemm_path("pallas", m=8, k=27, n=64,
                                     rank=5).skinny
    assert dispatch.GemmPlan("stacked", *qk.STACKED_TILE).use_pallas


def test_stacked_plan_matches_the_fused_plan():
    """A caller-built GemmPlan("stacked") runs the stacked route; its
    result is the static plan's (the fused route), bit for bit."""
    _, spec = _lowrank_pair(4, seed=4)
    a, b = _t(_rand_q((40, 64))), _t(_rand_q((64, 24)))
    plan = dispatch.choose_gemm_path("pallas", m=40, k=64, n=24,
                                     device="cpu", rank=4)
    assert plan.path == "fused" and not plan.skinny
    fused = ops.approx_qgemm_planned(a, b, spec, plan)
    stacked = ops.approx_qgemm_planned(
        a, b, spec, dispatch.GemmPlan("stacked", *qk.STACKED_TILE))
    assert torch.equal(stacked, fused)
    assert torch.equal(fused, G.approx_qgemm(a, b, spec))


def test_wrappers_check_what_the_kernels_take():
    _, spec = _lowrank_pair(2, seed=2)
    fu, fv = spec.fu_q, spec.fv_q
    s = ops.plane_scales(spec, 2, "meta")
    a = torch.empty((128, 64), dtype=torch.int8, device="meta")
    b = torch.empty((64, 128), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="not padded"):
        qgemm.approx_qgemm_fused(a[:100], b, fu, fv, s, k_valid=64)
    with pytest.raises(ValueError, match="k_valid"):
        qgemm.approx_qgemm_fused(a, b, fu, fv, s, k_valid=65)
    with pytest.raises(ValueError, match="tables"):
        qgemm.approx_qgemm_fused(a, b, fu, fv, s[:2], k_valid=64)
    with pytest.raises(ValueError, match="bad operands"):
        qgemm.approx_qgemm_stacked(a, b, s)
    with pytest.raises(ValueError, match="planes"):
        qgemm.approx_qgemm_stacked(a[None].expand(10, -1, -1),
                                   b[None].expand(10, -1, -1),
                                   torch.ones(10, device="meta"))
    with pytest.raises(ValueError, match="CUDA tensors"):
        qgemm.approx_qgemm_fused(a, b, fu, fv, s, k_valid=64)


# --- the Pareto front ----------------------------------------------------------

def test_nsga2_fork_matches_reference():
    cfg = dict(pop_size=8, generations=3, seed=1)
    jfront = jpareto.nsga2(jpareto.NSGAConfig(**cfg))
    tfront = pareto.nsga2(pareto.NSGAConfig(**cfg))
    assert len(tfront) == len(jfront) > 0
    for ji, ti in zip(jfront, tfront):
        np.testing.assert_array_equal(ti.mask, ji.mask)
        assert (ti.trunc_a, ti.trunc_b, ti.area, ti.nmed) == \
            (ji.trunc_a, ji.trunc_b, ji.area, ji.nmed)
    jm = jpareto.front_to_multipliers(jfront)
    tm = pareto.front_to_multipliers(tfront)
    assert [m.name for m in tm] == [m.name for m in jm]
    for band in (0.005, 0.02, 0.08):
        jp, tp = jpareto.pick_by_nmed(jm, band), pareto.pick_by_nmed(tm, band)
        assert tp.name == jp.name
        np.testing.assert_array_equal(tp.lut, jp.lut)
    pts = RNG.random((12, 3))
    np.testing.assert_array_equal(pareto.nondominated_front(pts),
                                  jpareto.nondominated_front(pts))
