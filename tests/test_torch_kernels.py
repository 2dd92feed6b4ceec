"""repro_torch kernels against the JAX package's Pallas kernels.

On the CPU every kernel wrapper runs its plain PyTorch version, and the
JAX kernels run as the JAX package's own tests run them (interpret mode
through `repro.kernels.ops`).  Integer paths are bit-exact; low-rank GEMMs
stay within rtol=1e-6, atol=1 of the JAX path (`tests/test_kernels.py`);
attention within 2e-6 in f32 and 2e-2 in bf16.

The CUDA kernels themselves are held against their plain versions on the
card by tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.approx import gemm as JG
from repro.core import multipliers as jmm
from repro.core import netlist as jnl
from repro.kernels import ops as jops
from repro_torch.approx import gemm as G
from repro_torch.core import multipliers as mm
from repro_torch.kernels import approx_qgemm as qk
from repro_torch.kernels import ops, qgemm, ref
from repro_torch.kernels import quantize as qz

RNG = np.random.default_rng(11)

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
    jspec = JG.from_multiplier(jmm.pruned(mask, name=f"tk_{seed}"),
                               rank=rank)
    tspec = G.from_multiplier(mm.pruned(mask, name=f"tk_{seed}"), rank=rank)
    return jspec, tspec


# --- quantize_rows -----------------------------------------------------------

@pytest.mark.parametrize("trunc", [0, 2])
@pytest.mark.parametrize("m,k", [(8, 16), (100, 300), (256, 1024), (3, 7)])
def test_quantize_rows_bitexact_with_jax_kernel(m, k, trunc):
    x = RNG.standard_normal((m, k)).astype(np.float32) * 3
    q_j, s_j = jops.quantize_rows(jnp.asarray(x), trunc=trunc)
    q_t, s_t = ops.quantize_rows(_t(x), trunc=trunc)
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    if trunc == 0:
        q_r, s_r = ref.ref_quantize_rows(_t(x))
        np.testing.assert_array_equal(q_t.numpy(), q_r.numpy())
        np.testing.assert_array_equal(s_t.numpy(), s_r.numpy())


# --- plane 0 / skinny, rank 0 ------------------------------------------------

GEMM_SHAPES = [(8, 16, 8), (64, 96, 80), (128, 128, 128), (100, 130, 50),
               (1, 256, 257), (300, 64, 512)]


@pytest.mark.parametrize("mult", ["exact", "trunc2x2", "trunc3x1"])
@pytest.mark.parametrize("shape", GEMM_SHAPES)
def test_qgemm_int_paths_bitexact(shape, mult):
    """Plane-0 and skinny (where m <= 32) on exact/trunc multipliers: the
    LUT oracle, the JAX kernel and the port agree bit for bit."""
    m, k, n = shape
    a, b = _rand_q((m, k)), _rand_q((k, n))
    mobj = mm.get_multiplier(mult)
    spec = G.from_multiplier(mobj)
    oracle = ref.lut_matmul(_t(a), _t(b), _t(mobj.lut)).numpy()
    got = ops.approx_qgemm(_t(a), _t(b), spec).numpy()
    want = np.asarray(jops.approx_qgemm(
        jnp.asarray(a), jnp.asarray(b),
        JG.from_multiplier(jmm.get_multiplier(mult))))
    np.testing.assert_array_equal(got, oracle.astype(np.float32))
    np.testing.assert_array_equal(got, want)
    if m <= qk.SKINNY_MAX_M:
        sk = ops.approx_qgemm(_t(a), _t(b), spec, skinny=True).numpy()
        np.testing.assert_array_equal(sk, oracle.astype(np.float32))


@pytest.mark.parametrize("mult", ["exact", "trunc2x2"])
@pytest.mark.parametrize("shape", [(4, 200, 256), (32, 512, 256)])
def test_skinny_int_paths_bitexact_with_jax_skinny(shape, mult):
    m, k, n = shape
    a, b = _rand_q((m, k)), _rand_q((k, n))
    got = ops.approx_qgemm(_t(a), _t(b), G.spec_from_name(mult),
                           skinny=True).numpy()
    want = np.asarray(jops.approx_qgemm(
        jnp.asarray(a), jnp.asarray(b), JG.spec_from_name(mult),
        skinny=True))
    np.testing.assert_array_equal(got, want)


# --- skinny, ranks 1..8 ------------------------------------------------------

@pytest.mark.parametrize("rank", [1, 2, 4, 8])
@pytest.mark.parametrize("shape", [(1, 256, 256), (8, 384, 130),
                                   (32, 130, 64)])
def test_skinny_lowrank_matches_jax(shape, rank):
    """Low-rank skinny (K-tail masked mapped planes) within rtol=1e-6,
    atol=1 of the JAX skinny kernel, and bit-identical to the port's own
    plain GEMM path (the same integer planes, the same flush order)."""
    m, k, n = shape
    a, b = _rand_q((m, k)), _rand_q((k, n))
    jspec, tspec = _lowrank_pair(rank, seed=rank)
    np.testing.assert_array_equal(tspec.fu_q.numpy(), np.asarray(jspec.fu_q))
    np.testing.assert_array_equal(tspec.s_r.numpy(), np.asarray(jspec.s_r))
    got = ops.approx_qgemm(_t(a), _t(b), tspec, skinny=True).numpy()
    want = np.asarray(jops.approx_qgemm(jnp.asarray(a), jnp.asarray(b),
                                        jspec, skinny=True))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1.0)
    np.testing.assert_array_equal(
        got, G.approx_qgemm(_t(a), _t(b), tspec).numpy())


def test_skinny_masks_padded_k_tail_in_mapped_planes():
    """k_valid < K: pad zeros map to tbl[0] != 0, so the mapped A must be
    zeroed past k_valid (a whole padded block here)."""
    _, spec = _lowrank_pair(2, seed=9)
    a, b = _rand_q((4, 128)), _rand_q((128, 128))
    ap = np.zeros((4, 256), np.int8)
    ap[:, :128] = a
    bp = np.zeros((256, 128), np.int8)
    bp[:128] = b
    got = qgemm.approx_qgemm_skinny(
        _t(ap), _t(bp.T), spec.fu_q, spec.fv_q,
        ops.plane_scales(spec, 2, "cpu"), k_valid=128)
    np.testing.assert_array_equal(
        got.numpy(), G.approx_qgemm(_t(a), _t(b), spec).numpy())


# --- flash attention ---------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bh,s,d", [(2, 128, 64), (4, 256, 128),
                                    (1, 64, 256)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_jax_kernel(bh, s, d, causal, dtype):
    q, k, v = (RNG.standard_normal((bh, s, d)).astype(np.float32)
               for _ in range(3))
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = getattr(torch, dtype)
    want = np.asarray(jops.flash_attention(
        jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd),
        causal=causal, bq=64, bkv=64), dtype=np.float32)
    got = ops.flash_attention(_t(q).to(td), _t(k).to(td), _t(v).to(td),
                              causal=causal, bq=64, bkv=64)
    assert got.dtype == td
    tol = 2e-6 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol * 3)
    oracle = ref.ref_attention(_t(q).to(td), _t(k).to(td), _t(v).to(td),
                               causal=causal)
    np.testing.assert_allclose(got.float().numpy(), oracle.float().numpy(),
                               rtol=tol, atol=tol * 3)


def test_flash_attention_block_size_invariance():
    q, k, v = (_t(RNG.standard_normal((2, 256, 64)).astype(np.float32))
               for _ in range(3))
    o1 = ops.flash_attention(q, k, v, bq=64, bkv=128)
    o2 = ops.flash_attention(q, k, v, bq=256, bkv=32)
    np.testing.assert_allclose(o1.numpy(), o2.numpy(), rtol=2e-6, atol=1e-6)


# --- routing ---------------------------------------------------------------

def test_wrappers_route_no_tensor_off_the_card_silently():
    """A tensor that is neither on the CPU nor on a CUDA device reaches no
    plain version: the wrappers raise."""
    x = torch.empty((4, 64), device="meta")
    with pytest.raises(ValueError):
        qz.quantize_rows(x, trunc=2)
    a = torch.empty((4, 128), dtype=torch.int8, device="meta")
    b = torch.empty((128, 128), dtype=torch.int8, device="meta")
    with pytest.raises((ValueError, NotImplementedError, RuntimeError)):
        qgemm.approx_qgemm_plane0(a, b)
