"""The host-side choices of the Hopper kernels' design, on the CPU.

- `qgemm.plane0_splits`: the plane-0 kernel's split of K (whole K tiles,
  a grid that covers the card at the serving prefill shapes, no split at
  large M);
- the K-major weight that `prepare_weight` keeps for the plane-0 kernel,
  and the plane-0 route through it, bit for bit against the JAX package's
  `approx_qgemm` (an integer path: exact);
- the flash kernel's f32 arithmetic (in-order FMA chains) and the 3xTF32
  tensor-core alternative, emulated in plain PyTorch, against the JAX
  flash kernel in interpret mode within the f32 contract (rtol=2e-6,
  atol=6e-6), and a one-pass TF32 emulation outside it.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.approx import gemm as JG
from repro.kernels import ops as jops
from repro_torch.approx import gemm as G
from repro_torch.kernels import approx_qgemm as qk
from repro_torch.kernels import ops, qgemm

RNG = np.random.default_rng(13)
SM_COUNT = 132
#: The four GEMM shapes of a TinyLlama-1.1B prefill at the 128 bucket.
PREFILL = [(128, 2048, 2048), (128, 2048, 256), (128, 2048, 5632),
           (128, 5632, 2048)]

torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# --- plane0_splits -----------------------------------------------------------

@pytest.mark.parametrize("shape", PREFILL + [(33, 257, 65), (64, 64, 64),
                                             (300, 64, 512),
                                             (128, 27, 64)])
def test_plane0_splits_cover_k_in_whole_tiles(shape):
    m, k, n = shape
    tk = qk.PLANE0_TILE[1]
    splits, k_chunk = qgemm.plane0_splits(m, k, n)
    k_pad = -(-k // tk) * tk
    assert splits >= 1 and k_chunk % tk == 0 and k_chunk >= tk
    chunks = [min(k_chunk, k_pad - z * k_chunk) for z in range(splits)]
    assert sum(chunks) == k_pad and min(chunks) > 0
    assert all(c % tk == 0 for c in chunks)


@pytest.mark.parametrize("shape", PREFILL)
def test_plane0_splits_fill_the_card_at_prefill(shape):
    m, k, n = shape
    tm, _, tn = qk.PLANE0_TILE
    splits, _ = qgemm.plane0_splits(m, k, n)
    assert (m // tm) * (n // tn) * splits >= SM_COUNT


@pytest.mark.parametrize("shape", [(4096, 2048, 2048), (4096, 2048, 256),
                                   (4096, 1152, 128), (6272, 2304, 256),
                                   (25088, 1152, 256), (100352, 1152, 128),
                                   (401408, 27, 64), (401408, 576, 64)])
def test_plane0_splits_none_at_large_m(shape):
    assert qgemm.plane0_splits(*shape) == (
        1, -(-shape[1] // qk.PLANE0_TILE[1]) * qk.PLANE0_TILE[1])


# --- the K-major weight of the plane-0 kernel --------------------------------

@pytest.mark.parametrize("mult", ["trunc2x2", "trunc3x1"])
def test_prepare_weight_keeps_k_major_copy(mult):
    spec = G.spec_from_name(mult).with_policy("pallas")
    single = _t(RNG.standard_normal((96, 40)).astype(np.float32))
    stacked = _t(RNG.standard_normal((3, 96, 40)).astype(np.float32))
    for w in (single, stacked):
        pw = G.prepare_weight(w, spec)
        assert pw.wq_t.shape == (*w.shape[:-2], 40, 96)
        assert pw.wq_t.is_contiguous()
        assert torch.equal(pw.wq_t, pw.wq.transpose(-1, -2))
    layer = G.prepare_weight(stacked, spec).layer(1)
    assert torch.equal(layer.wq_t, layer.wq.T)
    # the plain path never reads it: no copy where the kernels do not run
    assert G.prepare_weight(single, spec.with_policy("xla")).wq_t is None


@pytest.mark.parametrize("mult", ["exact", "trunc2x2", "trunc3x1"])
@pytest.mark.parametrize("shape", [(33, 257, 65), (300, 64, 512),
                                   (65, 130, 1), (100, 96, 200)])
def test_plane0_k_major_route_bitexact_with_jax(shape, mult):
    m, k, n = shape
    a = RNG.integers(-128, 128, (m, k)).astype(np.int8)
    b = RNG.integers(-128, 128, (k, n)).astype(np.int8)
    spec = G.spec_from_name(mult)
    want = np.asarray(jops.approx_qgemm(jnp.asarray(a), jnp.asarray(b),
                                        JG.spec_from_name(mult)))
    got = ops.approx_qgemm(_t(a), _t(b), spec, b_t=_t(b.T))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        ops.approx_qgemm(_t(a), _t(b), spec).numpy(), want)


def test_prepared_matmul_hands_the_k_major_weight_to_plane0(monkeypatch):
    """approx_matmul_prepared under trunc2x2 at m > 32 reaches the plane-0
    wrapper with the prepared K-major copy, and equals approx_matmul."""
    spec = G.spec_from_name("trunc2x2").with_policy("pallas")
    x = _t(RNG.standard_normal((40, 96)).astype(np.float32))
    w = _t(RNG.standard_normal((96, 72)).astype(np.float32))
    pw = G.prepare_weight(w, spec)
    seen = []
    real = qgemm.approx_qgemm_plane0

    def spy(a_q, b_t, **kw):
        seen.append(b_t)
        return real(a_q, b_t, **kw)

    monkeypatch.setattr(qgemm, "approx_qgemm_plane0", spy)
    with torch.no_grad():
        got = G.approx_matmul_prepared(x, pw, spec)
    assert len(seen) == 1
    tm, tk, tn = qk.PLANE0_TILE
    assert seen[0].shape == (-(-72 // tn) * tn, -(-96 // tk) * tk)
    assert torch.equal(seen[0][:72, :96], pw.wq_t)
    np.testing.assert_array_equal(got.numpy(),
                                  G.approx_matmul(x, w, spec).numpy())


# --- the flash kernel's f32 arithmetic ---------------------------------------

def _tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 (10 mantissa bits), ties away from zero: the
    PTX cvt.rna.tf32.f32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _mm(a, b, arith, init=None):
    """init + a @ b in one of three arithmetics: "fma", the CUDA kernel's
    in-order f32 FMA chain over the contraction (each step exact in
    float64, then rounded to f32); "3xtf32", tensor-core products
    lo_a hi_b + hi_a lo_b + hi_a hi_b, the small ones first; "tf32", one
    TF32 pass."""
    if arith == "fma":
        acc = torch.zeros(a.shape[:-1] + b.shape[-1:]) if init is None \
            else init
        for kk in range(a.shape[-1]):
            acc = (acc.double() + a[..., kk, None].double()
                   * b[..., kk, None, :].double()).float()
        return acc
    ah, al = _split(a)
    bh, bl = _split(b)
    out = ah @ bh if arith == "tf32" else (al @ bh + ah @ bl) + ah @ bh
    return out if init is None else init + out


def _flash_emulated(q, k, v, causal, arith, bkv=32):
    """The CUDA kernel's blocked online softmax on (bh, s, d) f32: 32-row
    kv tiles, both products in `arith`, O rescaled before P V is added."""
    bh, sq, d = q.shape
    skv = k.shape[1]
    scale = 1.0 / (d ** 0.5)
    m = torch.full((bh, sq, 1), -1e30)
    l = torch.zeros((bh, sq, 1))
    acc = torch.zeros((bh, sq, d))
    qi = torch.arange(sq)[:, None]
    for k0 in range(0, skv, bkv):
        kb, vb = k[:, k0:k0 + bkv], v[:, k0:k0 + bkv]
        s = _mm(q, kb.transpose(1, 2), arith) * scale
        if causal:
            kj = torch.arange(k0, k0 + kb.shape[1])[None, :]
            s = torch.where(qi >= kj, s, torch.full_like(s, -1e30))
        m_new = torch.maximum(m, s.amax(2, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(2, keepdim=True)
        acc = _mm(p, vb, arith, init=acc * alpha)
        m = m_new
    return acc / torch.clamp(l, min=1e-30)


#: `chip_smoke.check_kernels`' flash shapes.
FLASH_SHAPES = [(32, 128, 64), (2, 256, 128), (1, 64, 256), (3, 77, 64),
                (4, 100, 32)]


@pytest.mark.parametrize("bh,s,d", FLASH_SHAPES)
def test_flash_3xtf32_emulation_holds_the_f32_contract(bh, s, d):
    """The kernel's FMA arithmetic and 3xTF32 tensor-core products both stay
    within the f32 contract of the JAX kernel in interpret mode; one TF32
    pass does not.  (On the card 3xTF32 also rounds as the tensor cores
    accumulate, which this emulation does not model; the kernel runs FMAs.)
    """
    q, k, v = (RNG.standard_normal((bh, s, d)).astype(np.float32)
               for _ in range(3))
    blk = 64 if s % 64 == 0 else s          # the JAX kernel takes whole blocks
    want = np.asarray(jops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        bq=blk, bkv=blk))
    for arith in ("fma", "3xtf32"):
        got = _flash_emulated(_t(q), _t(k), _t(v), True, arith)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=6e-6)
    one_pass = _flash_emulated(_t(q), _t(k), _t(v), True, "tf32")
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(one_pass.numpy(), want, rtol=2e-6,
                                   atol=6e-6)


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10                       # TF32 spacing at 1
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2 ** -23,
                      one + 3 * ulp / 2, 3.0], dtype=torch.float32)
    np.testing.assert_array_equal(
        _tf32(x).numpy(),
        np.array([one + ulp, -(one + ulp), one, one + 2 * ulp, 3.0],
                 np.float32))
