"""The host-side choices of the Hopper kernels' design, on the CPU.

- `qgemm.plane0_splits`: the plane-0 kernel's split of K (whole K tiles,
  a grid that covers the card at the serving prefill shapes, no split at
  large M);
- the K-major weight that `prepare_weight` keeps for the plane-0 kernel,
  and the plane-0 route through it, bit for bit against the JAX package's
  `approx_qgemm` (an integer path: exact);
- the fused low-rank kernel's host side: its tile's width from N, the
  padding to that tile, the K-major weight it takes (prepared or
  transposed per call), the (R+1, N, K) weight planes it makes once per
  call, and the K-major route against the JAX fused kernel in interpret
  mode;
- the skinny kernel's host side: its split of K (a grid that covers the
  card at every TinyLlama decode shape, no empty split), the K-major
  weight it takes through both routes, no flush scales at rank 0, and its
  plain version on the K-major weight against the JAX skinny kernel in
  interpret mode;
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
from repro.core import multipliers as jmm
from repro.core import netlist as jnl
from repro.kernels import approx_qgemm as jqk
from repro.kernels import ops as jops
from repro_torch.approx import gemm as G
from repro_torch.core import multipliers as mm
from repro_torch.kernels import approx_qgemm as qk
from repro_torch.kernels import dispatch, ops, qgemm

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
    splits, k_chunk = qgemm.plane0_splits(m, k, n, sm_count=SM_COUNT)
    k_pad = -(-k // tk) * tk
    assert splits >= 1 and k_chunk % tk == 0 and k_chunk >= tk
    chunks = [min(k_chunk, k_pad - z * k_chunk) for z in range(splits)]
    assert sum(chunks) == k_pad and min(chunks) > 0
    assert all(c % tk == 0 for c in chunks)


@pytest.mark.parametrize("shape", PREFILL)
def test_plane0_splits_fill_the_card_at_prefill(shape):
    m, k, n = shape
    tm, _, tn = qk.PLANE0_TILE
    splits, _ = qgemm.plane0_splits(m, k, n, sm_count=SM_COUNT)
    assert (m // tm) * (n // tn) * splits >= SM_COUNT


@pytest.mark.parametrize("shape", [(4096, 2048, 2048), (4096, 2048, 256),
                                   (4096, 1152, 128), (6272, 2304, 256),
                                   (25088, 1152, 256), (100352, 1152, 128),
                                   (401408, 27, 64), (401408, 576, 64)])
def test_plane0_splits_none_at_large_m(shape):
    assert qgemm.plane0_splits(*shape, sm_count=SM_COUNT) == (
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


# --- the fused low-rank kernel -----------------------------------------------

def _lowrank_pair(rank, seed):
    """The same pruned multiplier compiled by both packages."""
    mask = np.random.default_rng(seed).random(
        len(jnl.bw8().prunable_gates())) < 0.03
    return (JG.from_multiplier(jmm.pruned(mask, name=f"hd_{seed}"),
                               rank=rank),
            G.from_multiplier(mm.pruned(mask, name=f"hd_{seed}"), rank=rank))


@pytest.mark.parametrize("n,width", [(64, 64), (1, 64), (192, 64),
                                     (320, 64), (128, 128), (65, 128),
                                     (256, 128), (512, 128), (4096, 128),
                                     (129, 64), (384, 128)])
def test_fused_tile_width_from_n(n, width):
    """The narrow 128 x 64 tile where it pads N to fewer columns (VGG16's
    conv1, N = 64), else the 128 x 128 one; N padded to the chosen width
    maps back to the same tile."""
    tile = qk.fused_tile(n)
    assert tile[2] == width and tile[:2] == qk.FUSED_TILE[:2]
    assert tile in (qk.FUSED_TILE, qk.FUSED_TILE_NARROW)
    padded = -(-n // width) * width
    assert padded <= -(-n // 128) * 128
    assert qk.fused_tile(padded) == tile
    for kernel in ("fused", "stacked"):
        assert qk.choose_blocks(300, 27, n, kernel=kernel) == tile
    plan = dispatch.choose_gemm_path("pallas", m=300, k=27, n=n, rank=5)
    assert (plan.bm, plan.bk, plan.bn) == tile


@pytest.mark.parametrize("prepared", [False, True])
@pytest.mark.parametrize("shape", [(300, 27, 64), (129, 100, 130),
                                   (200, 64, 192)])
def test_fused_route_pads_to_its_tile_and_takes_the_weight_k_major(
        monkeypatch, shape, prepared):
    """ops.approx_qgemm hands the fused wrapper A padded to (128, 32)
    multiples and the weight K-major, (N, K) contiguous and padded to the
    tile width and to 32, whether the caller keeps a K-major copy or the
    weight is transposed per call; the true K rides as k_valid."""
    m, k, n = shape
    _, spec = _lowrank_pair(2, seed=5)
    a = _t(RNG.integers(-128, 128, (m, k)).astype(np.int8))
    b = _t(RNG.integers(-128, 128, (k, n)).astype(np.int8))
    seen = []
    real = qgemm.approx_qgemm_fused

    def spy(a_q, b_t, fu_q, fv_q, scales, **kw):
        seen.append((a_q, b_t, kw))
        return real(a_q, b_t, fu_q, fv_q, scales, **kw)

    monkeypatch.setattr(qgemm, "approx_qgemm_fused", spy)
    got = ops.approx_qgemm(a, b, spec,
                           b_t=b.T.contiguous() if prepared else None)
    (ap, bt, kw), = seen
    tm, tk, tn = qk.fused_tile(n)
    mp, kp, np_ = -(-m // tm) * tm, -(-k // tk) * tk, -(-n // tn) * tn
    assert ap.shape == (mp, kp) and bt.shape == (np_, kp)
    assert bt.is_contiguous() and ap.is_contiguous()
    assert torch.equal(bt[:n, :k], b.T) and not bt[n:].any() and \
        not bt[:, k:].any()
    assert torch.equal(ap[:m, :k], a) and kw["k_valid"] == k
    assert torch.equal(got, G.approx_qgemm(a, b, spec))


@pytest.mark.parametrize("trunc_b", [0, 2])
@pytest.mark.parametrize("rank", [0, 1, 5])
def test_fused_weight_planes_are_table_maps_of_the_transposed_weight(
        rank, trunc_b):
    """The (R+1, N, K) planes the fused kernel makes once per call: plane 0
    the (masked) weight, plane r fv[r-1] mapped over the K-major weight,
    the transpose of build_stacks' (K, N) weight planes."""
    _, spec = _lowrank_pair(rank, seed=7)
    b = _t(RNG.integers(-128, 128, (96, 40)).astype(np.int8))
    planes = qgemm.lowrank_b_planes_plain(b.T.contiguous(), spec.fv_q,
                                          trunc_b=trunc_b)
    assert planes.shape == (rank + 1, 40, 96) and planes.dtype == torch.int8
    assert torch.equal(planes[0], G._trunc_mask(b.T, trunc_b))
    for r in range(rank):
        assert torch.equal(planes[r + 1], G._table_map(spec.fv_q[r], b.T))
    _, b_stack, _ = ops.build_stacks(b[:1], b, spec)
    if not trunc_b:
        assert torch.equal(planes, b_stack.transpose(1, 2))


@pytest.mark.parametrize("mult", ["pareto:0.01", "lowrank"])
def test_prepare_weight_keeps_k_major_copy_for_lowrank(monkeypatch, mult):
    """Low-rank specs keep the K-major weight for the fused kernel where
    the kernels run: under policy pallas, and under auto on a CUDA device
    (the device check monkeypatched); not on the plain path."""
    if mult == "lowrank":
        _, spec = _lowrank_pair(4, seed=8)
    else:
        spec = G.spec_from_name(mult)
    assert spec.mode == "lowrank" and spec.rank
    w = _t(RNG.standard_normal((3, 96, 40)).astype(np.float32))
    pw = G.prepare_weight(w, spec.with_policy("pallas"))
    assert pw.wq_t.shape == (3, 40, 96) and pw.wq_t.is_contiguous()
    assert torch.equal(pw.wq_t, pw.wq.transpose(-1, -2))
    assert torch.equal(pw.layer(2).wq_t, pw.layer(2).wq.T)
    assert G.prepare_weight(w, spec.with_policy("xla")).wq_t is None
    assert G.prepare_weight(w, spec.with_policy("auto")).wq_t is None
    real = dispatch.use_kernels
    monkeypatch.setattr(dispatch, "use_kernels",
                        lambda policy, device: real(policy, "cuda"))
    pw = G.prepare_weight(w, spec.with_policy("auto"))
    assert torch.equal(pw.wq_t, pw.wq.transpose(-1, -2))


def test_prepared_lowrank_matmul_hands_the_k_major_weight_to_fused(
        monkeypatch):
    """approx_matmul_prepared under a low-rank spec at m > 32 reaches the
    fused wrapper with the prepared K-major copy, and equals
    approx_matmul."""
    _, spec = _lowrank_pair(3, seed=6)
    spec = spec.with_policy("pallas")
    x = _t(RNG.standard_normal((40, 96)).astype(np.float32))
    w = _t(RNG.standard_normal((96, 72)).astype(np.float32))
    pw = G.prepare_weight(w, spec)
    seen = []
    real = qgemm.approx_qgemm_fused

    def spy(a_q, b_t, *args, **kw):
        seen.append(b_t)
        return real(a_q, b_t, *args, **kw)

    monkeypatch.setattr(qgemm, "approx_qgemm_fused", spy)
    with torch.no_grad():
        got = G.approx_matmul_prepared(x, pw, spec)
    assert len(seen) == 1
    assert torch.equal(seen[0][:72, :96], pw.wq_t)
    np.testing.assert_array_equal(got.numpy(),
                                  G.approx_matmul(x, w, spec).numpy())


@pytest.mark.parametrize("rank", [1, 2, 5])
@pytest.mark.parametrize("shape", [(129, 100, 64), (40, 64, 130)])
def test_fused_k_major_route_against_jax_fused_kernel(shape, rank):
    """The fused route on a K-major weight against the JAX fused kernel in
    interpret mode: bit-exact at rank 1; from rank 2 within the contract
    (rtol=1e-6, atol=1), where XLA contracts the JAX flush into FMAs
    (ROADMAP Queue 3); and bit-exact with the port's plain GEMM path."""
    m, k, n = shape
    a = RNG.integers(-128, 128, (m, k)).astype(np.int8)
    b = RNG.integers(-128, 128, (k, n)).astype(np.int8)
    jspec, tspec = _lowrank_pair(rank, seed=30 + rank)
    want = np.asarray(jops.approx_qgemm(jnp.asarray(a), jnp.asarray(b),
                                        jspec))
    got = ops.approx_qgemm(_t(a), _t(b), tspec, b_t=_t(b.T)).numpy()
    if rank == 1:
        np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1.0)
    np.testing.assert_array_equal(
        got, G.approx_qgemm(_t(a), _t(b), tspec).numpy())


# --- the skinny kernel -------------------------------------------------------

#: The five distinct GEMMs (K, N) of a TinyLlama-1.1B decode step.
DECODE = [(2048, 2048), (2048, 256), (2048, 5632), (5632, 2048),
          (2048, 32000)]


@pytest.mark.parametrize("kn", DECODE + [(25088, 4096), (4096, 4096),
                                         (4096, 1000), (304, 200), (16, 1),
                                         (272, 65), (128, 256)])
def test_skinny_splits_cover_k_without_an_empty_split(kn):
    """Split z sums the K units [z U / S, (z + 1) U / S): every unit once,
    none empty, none longer than SKINNY_MAX_BOXES boxes."""
    k, n = kn
    splits, gran = qgemm.skinny_splits(k, n, sm_count=SM_COUNT)
    assert gran in (32, qk.SKINNY_BOX) and 1 <= splits
    units = -(-k // gran)
    bounds = [z * units // splits * gran for z in range(splits + 1)]
    chunks = [min(k, hi) - lo for lo, hi in zip(bounds, bounds[1:])]
    assert min(chunks) > 0 and sum(chunks) == k
    assert max(chunks) <= qk.SKINNY_MAX_BOXES * qk.SKINNY_BOX


@pytest.mark.parametrize("kn", DECODE)
def test_skinny_splits_fill_the_card_at_decode(kn):
    k, n = kn
    splits, _ = qgemm.skinny_splits(k, n, sm_count=SM_COUNT)
    assert -(-n // qk.SKINNY_BM) * splits >= SM_COUNT


def _spy(monkeypatch, name):
    seen = []
    real = getattr(qgemm, name)

    def spy(a_q, b_t, *args, **kw):
        seen.append((a_q, b_t, args, kw))
        return real(a_q, b_t, *args, **kw)

    monkeypatch.setattr(qgemm, name, spy)
    return seen


@pytest.mark.parametrize("mult", ["trunc2x2", "lowrank"])
def test_prepared_matmul_hands_the_k_major_weight_to_skinny(monkeypatch,
                                                           mult):
    """approx_matmul_prepared at m <= 32 reaches the skinny wrapper with
    the prepared K-major copy (K padded to 16, N unpadded), and equals
    approx_matmul."""
    spec = (_lowrank_pair(3, seed=16)[1] if mult == "lowrank"
            else G.spec_from_name(mult)).with_policy("pallas")
    x = _t(RNG.standard_normal((4, 100)).astype(np.float32))
    w = _t(RNG.standard_normal((100, 72)).astype(np.float32))
    pw = G.prepare_weight(w, spec)
    seen = _spy(monkeypatch, "approx_qgemm_skinny")
    with torch.no_grad():
        got = G.approx_matmul_prepared(x, pw, spec)
    (a_q, b_t, _, kw), = seen
    assert a_q.shape == (4, 112) and b_t.shape == (72, 112)
    assert torch.equal(b_t[:, :100], pw.wq_t) and not b_t[:, 100:].any()
    assert kw["k_valid"] == 100
    np.testing.assert_array_equal(got.numpy(),
                                  G.approx_matmul(x, w, spec).numpy())


@pytest.mark.parametrize("rank", [0, 2])
def test_planned_skinny_route_takes_the_k_major_weight(monkeypatch, rank):
    """ops.approx_qgemm_planned on a skinny plan hands the caller's K-major
    weight to the wrapper as it is (no copy where K is a multiple of 16);
    without one, the weight is transposed per call.  Both equal the plain
    GEMM path."""
    spec = _lowrank_pair(rank, seed=17)[1] if rank else \
        G.spec_from_name("trunc3x1")
    a = _t(RNG.integers(-128, 128, (5, 96)).astype(np.int8))
    b = _t(RNG.integers(-128, 128, (96, 40)).astype(np.int8))
    b_t = b.T.contiguous()
    plan = dispatch.choose_gemm_path("pallas", m=5, k=96, n=40,
                                     rank=rank)
    assert plan.skinny and (plan.bk, plan.bn) == qk.SKINNY_TILE
    seen = _spy(monkeypatch, "approx_qgemm_skinny")
    with_bt = ops.approx_qgemm_planned(a, b, spec, plan, b_t)
    without = ops.approx_qgemm_planned(a, b, spec, plan)
    assert seen[0][1] is b_t
    assert torch.equal(seen[1][1], b_t) and seen[1][1].is_contiguous()
    want = G.approx_qgemm(a, b, spec)
    assert torch.equal(with_bt, want) and torch.equal(without, want)


def test_skinny_route_passes_no_scales_at_rank_0(monkeypatch):
    """At rank 0 the one plane's scale is 1: the skinny route neither
    calls plane_scales nor hands the wrapper a scale tensor; at rank > 0
    it does both."""
    calls = []
    real = ops.plane_scales
    monkeypatch.setattr(ops, "plane_scales",
                        lambda *a, **k: calls.append(a) or real(*a, **k))
    seen = _spy(monkeypatch, "approx_qgemm_skinny")
    a = _t(RNG.integers(-128, 128, (4, 64)).astype(np.int8))
    b = _t(RNG.integers(-128, 128, (64, 32)).astype(np.int8))
    for spec in (G.spec_from_name("exact"), G.spec_from_name("trunc2x2")):
        assert torch.equal(ops.approx_qgemm(a, b, spec, skinny=True),
                           G.approx_qgemm(a, b, spec))
    assert calls == [] and all(args[2] is None for _, _, args, _ in seen)
    spec = _lowrank_pair(2, seed=18)[1]
    ops.approx_qgemm(a, b, spec, skinny=True)
    assert len(calls) == 1 and seen[-1][2][2].shape == (3,)


@pytest.mark.parametrize("rank", [0, 1, 2, 5])
@pytest.mark.parametrize("shape", [(4, 300, 200), (1, 128, 65),
                                   (17, 100, 130)])
def test_skinny_plain_on_k_major_weight_against_jax_skinny(shape, rank):
    """The skinny wrapper's plain version on the K-major weight (K padded
    to 16, N unpadded) against the JAX skinny kernel in interpret mode:
    bit-exact at trunc and exact (rank 0) and at rank 1; from rank 2
    within the contract (rtol=1e-6, atol=1), where XLA contracts the JAX
    flush into FMAs (ROADMAP Queue 3)."""
    m, k, n = shape
    a = RNG.integers(-128, 128, (m, k)).astype(np.int8)
    b = RNG.integers(-128, 128, (k, n)).astype(np.int8)
    if rank:
        jspec, tspec = _lowrank_pair(rank, seed=50 + rank)
        mults = [(jspec, tspec, 0, 0)]
    else:
        mults = [(None, G.spec_from_name(name), ta, tb)
                 for name, ta, tb in (("exact", 0, 0), ("trunc2x2", 2, 2))]
    kp, npad = -(-k // 128) * 128, -(-n // 128) * 128
    ajp = np.zeros((m, kp), np.int8)
    ajp[:, :k] = a
    bjp = np.zeros((kp, npad), np.int8)
    bjp[:k, :n] = b
    k16 = -(-k // 16) * 16
    ap = np.zeros((m, k16), np.int8)
    ap[:, :k] = a
    btp = np.zeros((n, k16), np.int8)
    btp[:, :k] = b.T
    for jspec, tspec, ta, tb in mults:
        if rank:
            fu, fv = jspec.fu_q[:rank], jspec.fv_q[:rank]
            scales = jnp.concatenate([jnp.ones((1,), jnp.float32),
                                      -jspec.s_r])[:, None]
            tscales = ops.plane_scales(tspec, rank, "cpu")
        else:
            fu = fv = jnp.zeros((0, 256), jnp.int8)
            scales, tscales = jnp.ones((1, 1), jnp.float32), None
        want = np.asarray(jqk.approx_qgemm_skinny(
            jnp.asarray(ajp), jnp.asarray(bjp), fu, fv, scales, trunc_a=ta,
            trunc_b=tb, k_valid=k, bk=128, bn=128, interpret=True))[:, :n]
        got = qgemm.approx_qgemm_skinny(
            _t(ap), _t(btp), tspec.fu_q[:rank], tspec.fv_q[:rank], tscales,
            trunc_a=ta, trunc_b=tb, k_valid=k).numpy()
        assert got.shape == (m, n)
        if rank <= 1:
            np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1.0)
        np.testing.assert_array_equal(
            got, G.approx_qgemm(_t(a), _t(b), tspec).numpy())


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
