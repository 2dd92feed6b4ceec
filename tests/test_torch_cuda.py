"""repro_torch's CUDA kernels against their plain PyTorch versions on the
card.  Marked `cuda`: they skip on a machine without a CUDA device.  This
file imports no JAX, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.approx import gemm as G
from repro_torch.approx import layers as L
from repro_torch.core import multipliers as mm
from repro_torch.core import netlist as nl
from repro_torch.kernels import approx_qgemm as qk
from repro_torch.kernels import flash_attention as fk
from repro_torch.kernels import ops, qgemm
from repro_torch.kernels import quantize as qz


def _lowrank_spec(rank, seed):
    mask = np.random.default_rng(seed).random(
        len(nl.bw8().prunable_gates())) < 0.03
    return G.from_multiplier(mm.pruned(mask, name=f"tc_{seed}"), rank=rank)


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("trunc", [0, 2])
def test_cuda_quantize_rows_bitexact(cuda_dev, trunc):
    x = torch.randn((33, 2049), device=cuda_dev) * 3
    q1, s1 = qz.quantize_rows(x, trunc=trunc)
    q0, s0 = qz.quantize_rows_plain(x, trunc)
    assert torch.equal(q1, q0) and torch.equal(s1, s0)


def _same(got, want):
    """Bit-exact, a NaN equal to a NaN."""
    if not got.dtype.is_floating_point:
        return torch.equal(got, want)
    nan = got.isnan()
    return torch.equal(nan, want.isnan()) and torch.equal(
        torch.where(nan, 0, got), torch.where(nan, 0, want))


def _quantize_held(x, trunc):
    q1, s1 = qz.quantize_rows(x, trunc=trunc)
    q0, s0 = qz.quantize_rows_plain(x, trunc)
    assert _same(q1, q0) and _same(s1, s0)
    return q1, s1


# every launch-plan class at the main paths' sizes (VGG16's im2col and FC
# inputs and ResNet50's stem at batch 8, the decode rows), odd shapes, and
# two-pass rows
@pytest.mark.cuda
@pytest.mark.parametrize("trunc", [0, 2])
@pytest.mark.parametrize("m,k", [
    (401408, 27), (401408, 576), (100352, 1152), (25088, 2304),
    (6272, 4608), (1568, 4608), (8, 25088), (4, 2048), (4, 5632), (1, 2048),
    (100352, 147), (33, 257), (3, 7), (3, 40000), (3, 40001)])
def test_cuda_quantize_rows_every_plan_class(cuda_dev, m, k, trunc):
    gen = torch.Generator(device=cuda_dev).manual_seed(m + k)
    _quantize_held(torch.randn((m, k), generator=gen, device=cuda_dev) * 3,
                   trunc)


@pytest.mark.cuda
@pytest.mark.parametrize("trunc", [0, 2])
def test_cuda_quantize_rows_reads_row_slices_in_place(cuda_dev, trunc):
    big = torch.randn((9, 2056), device=cuda_dev)
    off, on = big[1:, 1:2049], big[1:, 8:2056]
    assert not qz.launch_plan(8, 2048, off.stride(0), off.data_ptr(),
                              sm_count=132).vec
    assert qz.launch_plan(8, 2048, on.stride(0), on.data_ptr(),
                          sm_count=132).vec
    for x in (off, on):
        _quantize_held(x, trunc)


@pytest.mark.cuda
@pytest.mark.parametrize("trunc", [0, 2])
@pytest.mark.parametrize("k", [37, 2048, 25088, 40000])
def test_cuda_quantize_rows_non_finite_rows(cuda_dev, k, trunc):
    x = torch.randn((8, k), device=cuda_dev) * 3
    x[0, 3] = float("nan")
    x[1, 5] = float("inf")
    x[2, 7] = -float("inf")
    x[3] = 0
    x[4] *= 1e-10
    x[5, 2], x[5, k - 1] = float("inf"), float("nan")
    q, s = _quantize_held(x, trunc)
    assert s[[0, 5]].isnan().all() and (s[1:3] == float("inf")).all()
    assert not q[:4].any() and not q[5].any() and q[4].any()


@pytest.mark.cuda
@pytest.mark.parametrize("mult", ["exact", "trunc2x2", "trunc3x1"])
@pytest.mark.parametrize("shape", [(128, 2048, 256), (33, 257, 65),
                                   (4, 2048, 512), (1, 300, 1000)])
def test_cuda_qgemm_int_paths_bitexact(cuda_dev, shape, mult):
    m, k, n = shape
    spec = G.spec_from_name(mult).to(cuda_dev)
    a = torch.randint(-128, 128, (m, k), dtype=torch.int8, device=cuda_dev)
    b = torch.randint(-128, 128, (k, n), dtype=torch.int8, device=cuda_dev)
    want = G.approx_qgemm(a, b, spec)
    assert torch.equal(ops.approx_qgemm(a, b, spec), want)
    if m <= qk.SKINNY_MAX_M:
        assert torch.equal(ops.approx_qgemm(a, b, spec, skinny=True), want)


@pytest.mark.cuda
@pytest.mark.parametrize("rank", [1, 2, 4, 8])
def test_cuda_skinny_lowrank_bitexact_with_plain(cuda_dev, rank):
    spec = _lowrank_spec(rank, seed=rank).to(cuda_dev)
    a = torch.randint(-128, 128, (5, 300), dtype=torch.int8, device=cuda_dev)
    b = torch.randint(-128, 128, (300, 200), dtype=torch.int8,
                      device=cuda_dev)
    got = ops.approx_qgemm(a, b, spec, skinny=True)
    assert torch.equal(got, G.approx_qgemm(a, b, spec))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-6),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_flash_attention(cuda_dev, dtype, tol, causal):
    q, k, v = (torch.randn((4, 100, 64), device=cuda_dev).to(dtype)
               for _ in range(3))
    got = fk.flash_attention(q, k, v, causal=causal)
    want = fk.flash_attention_plain(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=3 * tol)


# --- low rank: fused and stacked kernels --------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("rank", [1, 2, 4, 8])
@pytest.mark.parametrize("shape", [(128, 256, 128), (300, 257, 65),
                                   (256, 576, 64), (33, 4608, 512),
                                   (8192, 576, 64)])
def test_cuda_fused_lowrank_bitexact_with_plain(cuda_dev, shape, rank):
    """Fused kernel vs its plain version at a padded K tail (K = 257,
    4608 is a tile multiple), on the narrow tile at N = 64, and the stacked
    twin bit-identical to it."""
    m, k, n = shape
    spec = _lowrank_spec(rank, seed=rank).to(cuda_dev)
    a = torch.randint(-128, 128, (m, k), dtype=torch.int8, device=cuda_dev)
    b = torch.randint(-128, 128, (k, n), dtype=torch.int8, device=cuda_dev)
    got = ops.approx_qgemm(a, b, spec)
    assert torch.equal(got, G.approx_qgemm(a, b, spec))
    assert torch.equal(ops.approx_qgemm(a, b, spec, fused=False), got)


@pytest.mark.cuda
def test_cuda_fused_masks_fully_padded_k_tile(cuda_dev):
    """k_valid = 128 of K = 256: a whole K tile of pad zeros, which map to
    tbl[0] != 0 and must be masked in the mapped planes."""
    spec = _lowrank_spec(2, seed=9).to(cuda_dev)
    a = torch.randint(-128, 128, (128, 128), dtype=torch.int8,
                      device=cuda_dev)
    b = torch.randint(-128, 128, (128, 128), dtype=torch.int8,
                      device=cuda_dev)
    ap = torch.zeros((128, 256), dtype=torch.int8, device=cuda_dev)
    ap[:, :128] = a
    bp = torch.zeros((256, 128), dtype=torch.int8, device=cuda_dev)
    bp[:128] = b
    got = qgemm.approx_qgemm_fused(ap, bp.T.contiguous(), spec.fu_q,
                                   spec.fv_q,
                                   ops.plane_scales(spec, 2, cuda_dev),
                                   k_valid=128)
    assert torch.equal(got, G.approx_qgemm(a, b, spec))


@pytest.mark.cuda
@pytest.mark.parametrize("rank", [0, 1, 2, 4, 5, 8])
@pytest.mark.parametrize("shape", [(8192, 576, 64), (256, 300, 192),
                                   (128, 100, 256)])
def test_cuda_fused_every_rank_and_k_tail(cuda_dev, shape, rank):
    """The fused wrapper at every rank, rank 0 included (plane 0 alone), on
    both tile widths (N = 64 and 192 narrow, 256 wide), with k_valid ending
    inside a 64-byte K stage (300 of 320, 100 of 128) or at K (576),
    against its plain version and the plain GEMM path."""
    m, k, n = shape
    spec = _lowrank_spec(rank, seed=20 + rank).to(cuda_dev)
    a = torch.randint(-128, 128, (m, k), dtype=torch.int8, device=cuda_dev)
    b = torch.randint(-128, 128, (k, n), dtype=torch.int8, device=cuda_dev)
    tm, tk, tn = qk.fused_tile(n)
    assert n % tn == 0 and tn == (128 if n == 256 else 64)
    ap = ops._pad_to(a, 1, tk).contiguous()
    bt = ops._pad_to(b.T, 1, tk).contiguous()
    fu, fv = ops._tables(spec, rank, cuda_dev)
    scales = ops.plane_scales(spec, rank, cuda_dev)
    got = qgemm.approx_qgemm_fused(ap, bt, fu, fv, scales, k_valid=k)
    assert torch.equal(got, qgemm.approx_qgemm_fused_plain(
        ap, bt, fu, fv, scales, k_valid=k))
    assert torch.equal(got, G.approx_qgemm(a, b, spec))


@pytest.mark.cuda
def test_cuda_conv2d_kernel_path_matches_plain_path(cuda_dev):
    """conv2d under a rank-5 pruned multiplier (im2col M = 2*32*32 > 32:
    quantize_rows + the fused kernel) against the plain versions."""
    spec = _lowrank_spec(5, seed=5).to(cuda_dev)
    gen = torch.Generator(device=cuda_dev).manual_seed(0)
    x = torch.randn((2, 32, 32, 16), generator=gen, device=cuda_dev)
    w = torch.randn((3, 3, 16, 32), generator=gen, device=cuda_dev)
    n0 = qgemm.approx_qgemm_fused.launches
    got = L.conv2d(x, w, 1, 1, spec.with_policy("pallas"))
    assert qgemm.approx_qgemm_fused.launches == n0 + 1
    want = L.conv2d(x, w, 1, 1, spec.with_policy("xla"))
    assert torch.equal(got, want)


# --- the redesigned plane-0 and flash kernels ----------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("mult", ["exact", "trunc2x2"])
@pytest.mark.parametrize("shape", [(128, 2048, 2048), (128, 2048, 256),
                                   (128, 2048, 5632), (128, 5632, 2048),
                                   (25088, 1152, 256)])
def test_cuda_plane0_k_major_bitexact(cuda_dev, shape, mult):
    """The plane-0 kernel on a K-major weight (split K at the prefill
    shapes, none at large M) and on a transposed-per-call one, against the
    plain GEMM path."""
    m, k, n = shape
    spec = G.spec_from_name(mult).to(cuda_dev)
    a = torch.randint(-128, 128, (m, k), dtype=torch.int8, device=cuda_dev)
    b = torch.randint(-128, 128, (k, n), dtype=torch.int8, device=cuda_dev)
    want = G.approx_qgemm(a, b, spec)
    n0 = qgemm.approx_qgemm_plane0.launches
    assert torch.equal(ops.approx_qgemm(a, b, spec, b_t=b.T.contiguous()),
                       want)
    assert torch.equal(ops.approx_qgemm(a, b, spec), want)
    assert qgemm.approx_qgemm_plane0.launches == n0 + 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-6),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("bh,s,d", [(32, 128, 64), (3, 77, 32),
                                    (2, 256, 128), (1, 64, 256)])
def test_cuda_flash_attention_tensor_core_widths(cuda_dev, bh, s, d, dtype,
                                                 tol):
    gen = torch.Generator(device=cuda_dev).manual_seed(d)
    q, k, v = (torch.randn((bh, s, d), generator=gen, device=cuda_dev)
               .to(dtype) for _ in range(3))
    for causal in (True, False):
        got = fk.flash_attention(q, k, v, causal=causal)
        want = fk.flash_attention_plain(q, k, v, causal=causal, bq=64,
                                        bkv=64)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=3 * tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-6),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("bh,s,d,causal", [
    (16, 1500, 64, False),     # Whisper's encoder: 16 heads, 1500 frames
    (36, 128, 128, True),      # StarCoder2's prefill (36 query heads)
    (32, 128, 128, True)])     # the vision model's prefill
def test_cuda_flash_attention_conditioned_shapes(cuda_dev, bh, s, d, causal,
                                                 dtype, tol):
    gen = torch.Generator(device=cuda_dev).manual_seed(s + d)
    q, k, v = (torch.randn((bh, s, d), generator=gen, device=cuda_dev)
               .to(dtype) for _ in range(3))
    n0 = fk.flash_attention.launches
    got = fk.flash_attention(q, k, v, causal=causal)
    assert fk.flash_attention.launches == n0 + 1
    want = fk.flash_attention_plain(q, k, v, causal=causal, bq=64, bkv=64)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=3 * tol)


# --- the redesigned skinny kernel ----------------------------------------------

#: TinyLlama-1.1B's five distinct decode GEMMs (K, N) and VGG16's three FC
#: GEMMs.
DECODE_KN = [(2048, 2048), (2048, 256), (2048, 5632), (5632, 2048),
             (2048, 32000)]
VGG_FC_KN = [(25088, 4096), (4096, 4096), (4096, 1000)]


def _skinny_pair(a, b_t, spec, rank, k_valid, dev):
    """The skinny kernel and its plain version on the same operands."""
    fu, fv = ops._tables(spec, rank, dev)
    scales = ops.plane_scales(spec, rank, dev) if rank else None
    ta, tb, _ = ops._spec_kernel_args(spec)
    kw = dict(trunc_a=ta, trunc_b=tb, k_valid=k_valid)
    return (qgemm.approx_qgemm_skinny(a, b_t, fu, fv, scales, **kw),
            qgemm.approx_qgemm_skinny_plain(a, b_t, fu, fv, scales, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("rank", [0, 1, 2, 5, 8])
@pytest.mark.parametrize("m", [1, 3, 4, 8, 17, 32])
def test_cuda_skinny_every_m_and_rank_with_k_tail(cuda_dev, m, rank):
    """k_valid = 300 of K = 304 (the wrapper's 16-byte pad), N = 200 (no
    pad, a ragged last tile): kernel and plain version bit for bit, and
    the ops route equal to the plain GEMM path."""
    spec = (_lowrank_spec(rank, seed=40 + rank) if rank
            else G.spec_from_name("trunc2x2")).to(cuda_dev)
    a = torch.randint(-128, 128, (m, 300), dtype=torch.int8, device=cuda_dev)
    b = torch.randint(-128, 128, (300, 200), dtype=torch.int8,
                      device=cuda_dev)
    ap = ops._pad_to(a, 1, 16).contiguous()
    bt = ops._pad_to(b.T, 1, 16).contiguous()
    got, want = _skinny_pair(ap, bt, spec, rank, 300, cuda_dev)
    assert torch.equal(got, want)
    assert torch.equal(ops.approx_qgemm(a, b, spec, skinny=True),
                       G.approx_qgemm(a, b, spec))


@pytest.mark.cuda
@pytest.mark.parametrize("kn", DECODE_KN + VGG_FC_KN)
def test_cuda_skinny_main_path_shapes(cuda_dev, kn):
    """The decode step's GEMMs (m = 4, trunc2x2, and pareto:0.01 as the
    check phase serves it) and VGG16's FC GEMMs (m = 8, pareto:0.01), on
    the K-major weight, one launch per call."""
    k, n = kn
    m = 8 if kn in VGG_FC_KN else 4
    a = torch.randint(-128, 128, (m, k), dtype=torch.int8, device=cuda_dev)
    bt = torch.randint(-128, 128, (n, k), dtype=torch.int8, device=cuda_dev)
    mults = ["pareto:0.01"] if kn in VGG_FC_KN else ["trunc2x2",
                                                      "pareto:0.01"]
    for mult in mults:
        spec = G.spec_from_name(mult).to(cuda_dev)
        rank = ops._spec_kernel_args(spec)[2]
        n0 = qgemm.approx_qgemm_skinny.launches
        got, want = _skinny_pair(a, bt, spec, rank, k, cuda_dev)
        assert qgemm.approx_qgemm_skinny.launches == n0 + 1
        assert torch.equal(got, want), mult


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 4, 8, 32])
def test_cuda_skinny_whisper_tied_head(cuda_dev, m):
    """Whisper's tied head, (1024, 51865): an odd N that the route pads,
    through `ops.approx_qgemm` (the head is unprepared: its weight is
    transposed per call) and on the K-major weight against the plain
    version, bit for bit."""
    k, n = 1024, 51865
    spec = G.spec_from_name("trunc2x2").to(cuda_dev)
    a = torch.randint(-128, 128, (m, k), dtype=torch.int8, device=cuda_dev)
    b = torch.randint(-128, 128, (k, n), dtype=torch.int8, device=cuda_dev)
    got = ops.approx_qgemm(a, b, spec, skinny=True)
    assert got.shape == (m, n)
    assert torch.equal(got, G.approx_qgemm(a, b, spec))
    kern, plain = _skinny_pair(a, b.T.contiguous(), spec, 0, k, cuda_dev)
    assert torch.equal(kern, plain)


@pytest.mark.cuda
def test_cuda_skinny_back_to_back_calls_leave_nothing_behind(cuda_dev):
    """Calls of different shapes, splits and ranks back to back on one
    stream, three rounds: the self-resetting counters and the shared
    workspace carry nothing from one call to the next."""
    cases = []
    for i, (m, k, n, rank) in enumerate([(4, 2048, 256, 0), (4, 2048, 2048, 5),
                                         (8, 4096, 1000, 5), (1, 304, 200, 2),
                                         (32, 2048, 256, 8),
                                         (4, 2048, 32000, 0)]):
        spec = (_lowrank_spec(rank, seed=60 + i) if rank
                else G.spec_from_name("trunc2x2")).to(cuda_dev)
        a = torch.randint(-128, 128, (m, k), dtype=torch.int8,
                          device=cuda_dev)
        bt = torch.randint(-128, 128, (n, k), dtype=torch.int8,
                           device=cuda_dev)
        want = _skinny_pair(a, bt, spec, rank, k, cuda_dev)[1]
        cases.append((a, bt, spec, rank, k, want))
    for _ in range(3):
        outs = [_skinny_pair(a, bt, spec, rank, k, cuda_dev)[0]
                for a, bt, spec, rank, k, _ in cases]
        for got, case in zip(outs, cases):
            assert torch.equal(got, case[-1])


@pytest.mark.cuda
def test_cuda_skinny_refuses_a_row_major_weight(cuda_dev):
    a = torch.zeros((4, 256), dtype=torch.int8, device=cuda_dev)
    b = torch.zeros((256, 128), dtype=torch.int8, device=cuda_dev)
    empty = torch.zeros((0, 256), dtype=torch.int8, device=cuda_dev)
    with pytest.raises(ValueError, match="K-major"):
        qgemm.approx_qgemm_skinny(a, b, empty, empty, k_valid=256)


# --- the co-design core on the card -----------------------------------------

def _ga_mults():
    from repro_torch.core import ga
    mults = [mm.exact_multiplier(), mm.truncated(1, 1), mm.truncated(2, 2),
             mm.truncated(3, 3), _pruned_mult(3)]
    ga._register(mults)
    return mults


def _pruned_mult(seed):
    mask = np.random.default_rng(seed).random(
        len(nl.bw8().prunable_gates())) < 0.03
    return mm.pruned(mask, name=f"tc_ga_{seed}")


@pytest.mark.cuda
def test_cuda_evaluate_population_matches_the_cpu(cuda_dev):
    """The FPS lattice and every genome's metrics on the card equal the
    CPU's to rtol 1e-6 (float32 on both; the card's division by a scalar
    and its sums may round differently), the same `inf` places and the same
    feasible mask."""
    from repro_torch.core import ga_batched as gb
    for workload, fps_min in (("vgg16", 30.0), ("resnet50", 400.0)):
        space = gb.build_space(workload, 7, fps_min, 2.0, mults=_ga_mults(),
                               device=cuda_dev)
        cpu = gb.build_space(workload, 7, fps_min, 2.0, mults=_ga_mults(),
                             device="cpu")
        np.testing.assert_allclose(space.fps_table, cpu.fps_table,
                                   rtol=1e-6)
        pop = gb.exhaustive_population(space)
        got = gb.evaluate_population(pop, space.tables(cuda_dev), 7)
        want = gb.evaluate_population(pop, space.tables("cpu"), 7)
        assert got["fitness"].device.type == "cuda"
        assert torch.equal(got["feasible"].cpu(), want["feasible"])
        for k in got:
            if k == "feasible":
                continue
            g, w = got[k].cpu(), want[k]
            assert not torch.isnan(g).any()
            assert torch.equal(torch.isinf(g), torch.isinf(w)), k
            fin = torch.isfinite(w)
            torch.testing.assert_close(g[fin], w[fin], rtol=1e-6, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["vgg16", "resnet50"])
def test_cuda_ga_finds_the_exhaustive_optimum(cuda_dev, workload):
    from repro_torch.core import ga
    from repro_torch.core import ga_batched as gb
    cfg = gb.BatchedGAConfig(pop_size=2048, generations=8, seed=0)
    rb = gb.run_ga_batched(workload, 7, 30.0, 2.0, mults=_ga_mults(),
                           cfg=cfg, device=cuda_dev)
    _, met = gb.exhaustive_best(rb.space, device=cuda_dev)
    assert rb.best.fitness <= float(met["fitness"]) * (1 + 1e-4)
    rn = ga.run_ga(workload, 7, 30.0, 2.0, mults=_ga_mults(),
                   cfg=ga.GAConfig(pop_size=32, generations=16, seed=0))
    assert rb.best.fitness == pytest.approx(rn.best.fitness, rel=1e-6)
    # the same seed repeats on the card
    again = gb.run_ga_batched(workload, 7, 30.0, 2.0, mults=_ga_mults(),
                              cfg=cfg, device=cuda_dev)
    assert again.history == rb.history
    np.testing.assert_array_equal(again.population, rb.population)


@pytest.mark.cuda
@pytest.mark.parametrize("m,mult,skinny,kernel", [
    (16, "trunc2x2", True, "approx_qgemm_skinny"),
    (128, "trunc2x2", False, "approx_qgemm_plane0"),
    (128, "tc_ga_3", False, "approx_qgemm_fused")])
def test_cuda_calibrate_gemm_records_a_kernel_plan(cuda_dev, m, mult, skinny,
                                                  kernel):
    from repro_torch.core import calibrate as cal
    _ga_mults()
    fn = getattr(qgemm, kernel)
    fn.launches = 0
    c = cal.calibrate_gemm(m=m, k=2048, n=512, mult_name=mult, reps=3,
                           device=cuda_dev)
    assert c.meta["dispatch"]["path"] == "fused"
    assert c.meta["dispatch"]["skinny"] is skinny
    assert c.meta["backend"] == torch.cuda.get_device_name(cuda_dev)
    assert fn.launches == 4           # the warm-up and three timed calls
    assert c.measured > 0 and c.scale > 0


@pytest.mark.cuda
def test_cuda_paged_engine_token_identical_to_slot_engine(cuda_dev):
    """The reduced PagedEngine, chunked and trunc4x4-speculative, through
    the kernels on the card: every stream equal to the slot engine's
    through the kernels, and the paged path launched the decode kernels."""
    from repro_torch import configs
    from repro_torch.kernels import qgemm
    from repro_torch.models import api
    from repro_torch.serving import (
        Engine, PagedEngine, Request, SamplingParams)
    cfg = configs.reduced(configs.get_config("tinyllama-1.1b"),
                          mult="trunc2x2", kernel_policy="pallas",
                          attn_impl="flash")
    params = api.init_params(cfg, 0, cuda_dev)
    rng = np.random.default_rng(1)
    trace = []
    for i in range(6):
        sp = SamplingParams(max_new_tokens=int(rng.integers(3, 7))) \
            if i % 3 else SamplingParams(temperature=0.8, top_k=8,
                                         max_new_tokens=4, seed=50 + i)
        trace.append(Request(f"r{i}", rng.integers(
            1, cfg.vocab, int(rng.integers(4, 40))).tolist(), sp,
            arrival=float(i // 2)))

    def serve(eng):
        for req in trace:
            eng.submit(req)
        return {c.request_id: (c.tokens, c.finish_reason)
                for c in eng.run_until_complete()}

    base = serve(Engine(cfg, params, capacity=3, max_len=64,
                        device=cuda_dev))
    qgemm.approx_qgemm_skinny.launches = 0
    eng = PagedEngine(cfg, params, capacity=3, max_len=64, page_size=8,
                      prefill_chunk=8, draft_tier="trunc4x4", spec_k=3,
                      device=cuda_dev)
    assert serve(eng) == base
    st = eng.stats()
    assert st["paged"]["chunked"]["chunks"] > 0 and st["spec"]["steps"] > 0
    assert qgemm.approx_qgemm_skinny.launches > 0
    eng._alloc.audit()
    assert eng._alloc.pages_live == 0



@pytest.mark.cuda
def test_cuda_metered_fleet_failover_matches_a_lone_engine(cuda_dev):
    """A reduced metered two-replica fleet through the kernels on the
    card, replica 0 killed at its step 3: nothing lost, each replica's
    meter conserves energy, and every stream equals a lone slot engine's
    on the card."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.fleet import chaos
    from repro_torch.fleet.meter import DevicePowerModel
    from repro_torch.kernels import qgemm
    from repro_torch.launch import fleet as launch
    from repro_torch.models import api
    from repro_torch.serving import Engine
    cfg = configs.reduced(configs.get_config("tinyllama-1.1b"),
                          mult="trunc2x2", kernel_policy="pallas",
                          attn_impl="flash")
    params = api.init_params(cfg, 0, cuda_dev)
    fleet = launch.build_fleet(cfg, trace="diurnal", capacity=2, max_len=48,
                               params=params, device=cuda_dev,
                               power=DevicePowerModel(tdp_w=700.0))
    reqs = launch.poisson_requests(8, 6, 6, cfg.vocab, seed=0)
    for r in reqs:
        fleet.submit(r)
    fleet.replicas[0].inject_fault(at_step=3)
    qgemm.approx_qgemm_skinny.launches = 0
    comps = fleet.run_until_complete()
    assert qgemm.approx_qgemm_skinny.launches > 0
    assert fleet.stats()["lost"] == [] and fleet.requeued >= 1
    assert [e["replica"] for e in fleet.requeue_events] == ["us-west"]
    assert chaos.check_meter_conservation(fleet, {}) == []
    assert chaos.check_exactly_once(
        fleet, {r.request_id: r for r in reqs}) == []
    lone = Engine(cfg, params, capacity=2, max_len=48, device=cuda_dev)
    for r in reqs:
        lone.submit(dataclasses.replace(r, arrival=0.0))
    want = {c.request_id: c.tokens for c in lone.run_until_complete()}
    assert {c.request_id: c.tokens for c in comps} == want


_RECURRENT = [("mamba2-370m", dict(ssd_chunk=16)),
              ("recurrentgemma-9b", dict(n_layers=4, window=16))]


@pytest.mark.cuda
@pytest.mark.parametrize("arch,over", _RECURRENT)
def test_cuda_recurrent_models_kernels_match_plain(cuda_dev, arch, over):
    """The reduced mamba2 (SSD chunks of 16) and hybrid (4 layers, window
    16) on the card: 48-token prompts (three SSD chunks; rings that wrap)
    and six decode steps, once through the kernels and once through the
    plain versions.  The kernels are bit-exact with their plain versions
    and every other op is the same on both sides, so the logits agree
    within 1e-4 (room for nothing but rounding) and the greedy tokens are
    equal; the plain run launches no kernel."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.kernels import qgemm
    from repro_torch.models import api
    cfg = configs.reduced(configs.get_config(arch), mult="trunc2x2", **over)
    params = api.init_params(cfg, 0, cuda_dev)
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (3, 48))).to(cuda_dev)
    true_len = torch.tensor([48, 30, 17], dtype=torch.int32, device=cuda_dev)
    runs = {}
    for policy in ("pallas", "xla"):
        c = dataclasses.replace(cfg, kernel_policy=policy)
        spec = api.make_spec(c, device=cuda_dev)
        p = api.prepare_params(params, c, spec)
        qgemm.approx_qgemm_plane0.launches = 0
        logits, cache = api.prefill(p, toks, c, spec, true_len=true_len)
        assert (qgemm.approx_qgemm_plane0.launches > 0) == (
            policy == "pallas")
        runs[policy] = [c, spec, p, cache, [logits]]
    for _ in range(6):
        # both sides decode the kernel run's greedy tokens
        tok = runs["pallas"][4][-1].argmax(-1)[:, None]
        for run in runs.values():
            c, spec, p, cache, out = run
            logits, run[3] = api.decode_step(p, cache, tok, c, spec)
            out.append(logits[:, -1])
    for a, b in zip(runs["pallas"][4], runs["xla"][4]):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)
        assert torch.equal(a.argmax(-1), b.argmax(-1))


@pytest.mark.cuda
@pytest.mark.parametrize("arch,over", _RECURRENT)
def test_cuda_recurrent_paged_engine_token_identical(cuda_dev, arch, over):
    """The reduced recurrent families through the kernels on the card: the
    paged engine, chunked and speculative (the serving tier drafting),
    emits the slot engine's tokens, and its decode ran the skinny
    kernel.  The hybrid keeps the reduced window (32) above every prompt:
    past the window whole and chunked prefill differ in the reference
    too (tests/test_torch_hybrid.py)."""
    from repro_torch import configs
    from repro_torch.kernels import qgemm
    from repro_torch.models import api
    from repro_torch.serving import (
        Engine, PagedEngine, Request, SamplingParams)
    over = {k: v for k, v in over.items() if k != "window"}
    cfg = configs.reduced(configs.get_config(arch), mult="trunc2x2",
                          kernel_policy="pallas", **over)
    params = api.init_params(cfg, 0, cuda_dev)
    rng = np.random.default_rng(1)
    trace = []
    for i in range(6):
        sp = SamplingParams(max_new_tokens=int(rng.integers(3, 7))) \
            if i % 3 else SamplingParams(temperature=0.8, top_k=8,
                                         max_new_tokens=4, seed=50 + i)
        trace.append(Request(f"r{i}", rng.integers(
            1, cfg.vocab, int(rng.integers(4, 28))).tolist(), sp,
            arrival=float(i // 2)))

    def serve(eng):
        for req in trace:
            eng.submit(req)
        return {c.request_id: (c.tokens, c.finish_reason)
                for c in eng.run_until_complete()}

    base = serve(Engine(cfg, params, capacity=3, max_len=64,
                        device=cuda_dev))
    qgemm.approx_qgemm_skinny.launches = 0
    eng = PagedEngine(cfg, params, capacity=3, max_len=64, page_size=8,
                      prefill_chunk=8, draft_tier="trunc2x2", spec_k=3,
                      device=cuda_dev)
    assert serve(eng) == base
    st = eng.stats()
    assert st["paged"]["chunked"]["chunks"] > 0 and st["spec"]["steps"] > 0
    assert st["spec"]["acceptance_rate"] == 1.0
    assert qgemm.approx_qgemm_skinny.launches > 0
    eng._alloc.audit()
    assert eng._alloc.pages_live == 0


_MOE = [("grok-1-314b", dict(n_layers=1)),
        ("llama4-maverick-400b-a17b", dict(n_layers=2))]


@pytest.mark.cuda
@pytest.mark.parametrize("arch,over", _MOE)
def test_cuda_moe_layer_kernels_match_plain(cuda_dev, arch, over):
    """One MoE layer on the card (reduced grok-1 at 1 layer; reduced
    llama4-maverick as its superblock of a dense and an MoE layer with the
    shared expert): 24-token prompts and six decode steps, once through
    the kernels and once through the plain versions.  The kernels are
    bit-exact with their plain versions and the router runs the same f32
    ops on both sides, so the logits are equal, and so is every call's
    routing (expert indices, drop mask); the plain run launches no
    kernel."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.kernels import qgemm
    from repro_torch.models import api, moe
    cfg = configs.reduced(configs.get_config(arch), mult="trunc2x2", **over)
    params = api.init_params(cfg, 0, cuda_dev)
    rng = np.random.default_rng(4)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (3, 24))).to(cuda_dev)
    true_len = torch.tensor([24, 15, 9], dtype=torch.int32, device=cuda_dev)
    runs = {}
    for policy in ("pallas", "xla"):
        c = dataclasses.replace(cfg, kernel_policy=policy)
        spec = api.make_spec(c, device=cuda_dev)
        p = api.prepare_params(params, c, spec)
        qgemm.approx_qgemm_skinny.launches = 0
        with moe.recording() as routing:
            logits, cache = api.prefill(p, toks, c, spec, true_len=true_len,
                                        max_len=32)
            out = [logits]
            for _ in range(6):
                tok = (runs["pallas"][0][len(out) - 1] if runs else
                       out[-1]).argmax(-1)[:, None]
                logits, cache = api.decode_step(p, cache, tok, c, spec)
                out.append(logits[:, -1])
        assert (qgemm.approx_qgemm_skinny.launches > 0) == (
            policy == "pallas")
        runs[policy] = (out, routing)
    (kernel, rk), (plain, rp) = runs["pallas"], runs["xla"]
    for a, b in zip(kernel, plain):
        assert torch.isfinite(a).all() and torch.equal(a, b)
    assert len(rk) == len(rp) == 7
    for a, b in zip(rk, rp):
        assert torch.equal(a.expert_idx, b.expert_idx)
        assert torch.equal(a.keep, b.keep)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,over", _MOE)
def test_cuda_moe_paged_engine_token_identical(cuda_dev, arch, over):
    """The reduced MoE models through the kernels on the card: the paged
    engine emits the slot engine's tokens; chunked and speculative too
    on the copy of the config whose capacity drops nothing (on the real
    config their decode calls put other rows beside a token, and the
    rows of a call share its expert capacity:
    tests/test_torch_moe_engine.py)."""
    from repro_torch import configs
    from repro_torch.kernels import qgemm
    from repro_torch.models import api, moe
    from repro_torch.serving import (
        Engine, PagedEngine, Request, SamplingParams)
    real = configs.reduced(configs.get_config(arch), mult="trunc2x2",
                           kernel_policy="pallas", **over)
    rng = np.random.default_rng(1)
    trace = []
    for i in range(6):
        sp = SamplingParams(max_new_tokens=int(rng.integers(3, 7))) \
            if i % 3 else SamplingParams(temperature=0.8, top_k=8,
                                         max_new_tokens=4, seed=50 + i)
        trace.append(Request(f"r{i}", rng.integers(
            1, real.vocab, int(rng.integers(4, 28))).tolist(), sp,
            arrival=float(i // 2)))

    def serve(eng):
        for req in trace:
            eng.submit(req)
        return {c.request_id: (c.tokens, c.finish_reason)
                for c in eng.run_until_complete()}

    for cfg, kw in ((real, {}), (moe.no_drop(real), dict(
            prefill_chunk=8, draft_tier="trunc2x2", spec_k=3))):
        params = api.init_params(cfg, 0, cuda_dev)
        base = serve(Engine(cfg, params, capacity=3, max_len=64,
                            device=cuda_dev))
        qgemm.approx_qgemm_skinny.launches = 0
        eng = PagedEngine(cfg, params, capacity=3, max_len=64, page_size=8,
                          device=cuda_dev, **kw)
        assert serve(eng) == base
        assert qgemm.approx_qgemm_skinny.launches > 0
        eng._alloc.audit()
        assert eng._alloc.pages_live == 0


# --- training ----------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_flash_refuses_autograd_and_chunked_matches_naive(cuda_dev):
    """On the card the flash kernel raises for inputs that need a
    gradient, launching nothing; the chunked attention's custom backward
    agrees with autograd through the naive attention."""
    from repro_torch.models import common as C
    gen = torch.Generator(device=cuda_dev).manual_seed(0)
    q = torch.randn((2, 128, 8, 64), device=cuda_dev, generator=gen)
    k, v = (torch.randn((2, 128, 2, 64), device=cuda_dev, generator=gen)
            for _ in range(2))
    grad = torch.randn(q.shape, device=cuda_dev, generator=gen)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    n0 = fk.flash_attention.launches
    with pytest.raises(RuntimeError, match="no backward"):
        C.attention(q, k, v, impl="flash", chunk=32, policy="pallas")
    assert fk.flash_attention.launches == n0
    got = torch.autograd.grad(C.attention(q, k, v, impl="chunked", chunk=32),
                              (q, k, v), grad)
    want = torch.autograd.grad(C.naive_attention(q, k, v), (q, k, v), grad)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("mult", ["trunc2x2", "pareto:0.01"])
def test_cuda_train_step_kernels_match_plain(cuda_dev, mult):
    """One train step of reduced TinyLlama (M = 256 rows: plane 0, or the
    fused kernel under the low-rank multiplier) through the kernels and
    through the plain versions from the same state: the forward GEMMs
    are bit-exact and the backward is the same ops, so loss, gradient
    norm and every updated param are equal."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.data import synthetic
    from repro_torch.train import train_step as ts
    cfg = configs.reduced(configs.get_config("tinyllama-1.1b"), mult=mult,
                          remat=True)
    batch = ts.batch_to(synthetic.batch_for(cfg, "train", 8, 32, 0, 0),
                        cuda_dev)
    out = {}
    for policy in ("pallas", "xla"):
        c = dataclasses.replace(cfg, kernel_policy=policy)
        init, step = ts.make_train_fns(c, ts.StepOptions(), cuda_dev)
        n = {f: getattr(qgemm, f).launches for f in
             ("approx_qgemm_plane0", "approx_qgemm_fused")}
        out[policy] = step(init(0), batch)
        torch.cuda.synchronize()
        tiled = "approx_qgemm_fused" if mult.startswith("pareto") \
            else "approx_qgemm_plane0"
        ran = getattr(qgemm, tiled).launches - n[tiled]
        assert ran == (15 + 14 * cfg.remat if policy == "pallas" else 0)
    (sp, mp), (sx, mx) = out["pallas"], out["xla"]
    assert torch.equal(mp["loss"], mx["loss"])
    assert torch.equal(mp["gnorm"], mx["gnorm"])
    for name, p in sp["params"]["layers"].items():
        assert torch.equal(p, sx["params"]["layers"][name]), name
    assert torch.equal(sp["params"]["lm_head"], sx["params"]["lm_head"])


# --- the autotuner's candidates on the card -----------------------------------

def _tuning_spec(mult, dev):
    spec = G.spec_from_name(mult).to(dev)
    rank = spec.rank if spec.mode == "lowrank" else 0
    return spec, rank


@pytest.mark.cuda
@pytest.mark.parametrize("mult,mkn", [
    ("trunc2x2", (4, 2048, 2048)), ("trunc2x2", (4, 2048, 256)),
    ("pareto:0.01", (8, 4096, 1000)), ("trunc2x2", (128, 2048, 256)),
    ("trunc2x2", (128, 5632, 2048)), ("trunc2x2", (512, 2048, 2048)),
    ("pareto:0.01", (300, 576, 64)), ("pareto:0.01", (256, 1152, 192))])
def test_cuda_every_tuning_candidate_is_bitexact(cuda_dev, mult, mkn):
    """Every plan the tuner may time (each split count of plane 0 and
    skinny, each tile width of fused and stacked) sums the same exact
    int32 planes and flushes them in the same order: bit-equal to the
    plain version."""
    from repro_torch.kernels import autotune
    spec, rank = _tuning_spec(mult, cuda_dev)
    m, k, n = mkn
    gen = torch.Generator(device=cuda_dev).manual_seed(7)
    a = torch.randint(-128, 128, (m, k), generator=gen, device=cuda_dev,
                      dtype=torch.int8)
    b = torch.randint(-128, 128, (k, n), generator=gen, device=cuda_dev,
                      dtype=torch.int8)
    bt = b.T.contiguous()
    want = G.approx_qgemm(a, b, spec)
    sms = torch.cuda.get_device_properties(cuda_dev).multi_processor_count
    cands = autotune.candidate_plans(m, k, n, rank + 1, sm_count=sms)
    for c in [*cands, *autotune.STACKED_CANDIDATES]:
        if c.path == "stacked":
            got = ops.approx_qgemm(a, b, spec, fused=False, bn=c.bn)
        else:
            got = ops.approx_qgemm(
                a, b, spec, b_t=bt, skinny=c.skinny, splits=c.splits,
                bn=c.bn if rank and not c.skinny else None)
        assert torch.equal(got, want), c.label


@pytest.mark.cuda
def test_cuda_tune_gemm_fills_the_cache_dispatch_reads(cuda_dev, tmp_path,
                                                       monkeypatch):
    """The tuner measures on the card (positive times for every timed
    plan and the plain path), persists the winner under the card's key,
    and "auto" dispatch then runs it, bit-equal to the plain path."""
    from repro_torch.kernels import autotune, dispatch
    monkeypatch.setenv("REPRO_TUNING_CACHE", str(tmp_path / "t.json"))
    monkeypatch.delenv("REPRO_KERNEL_POLICY", raising=False)
    spec, _ = _tuning_spec("trunc2x2", cuda_dev)
    plan = autotune.tune_gemm(4, 2048, 2048, spec, device=cuda_dev, reps=3)
    assert plan.path in autotune.KERNEL_PATHS
    assert all(us > 0 for us in plan.candidates.values())
    assert plan.us["xla"] > 0 and plan.static in plan.candidates
    got = dispatch.choose_gemm_path("auto", m=4, k=2048, n=2048,
                                    device=cuda_dev, mode=spec.mode)
    assert got.source == "tuned" and got.path == plan.path
    x = torch.randn((4, 2048), device=cuda_dev)
    w = torch.randn((2048, 2048), device=cuda_dev)
    tuned = L.dense(x, w, None, spec.with_policy("auto"))
    plain = L.dense(x, w, None, spec.with_policy("xla"))
    assert torch.equal(tuned, plain)


@pytest.mark.cuda
def test_cuda_tensor_parallel_world_of_two(cuda_dev):
    """Two ranks sharing the card over gloo: the column-parallel GEMM
    through the kernels bit-equal to one device, and the reduced TinyLlama
    served at model=2 token for token as one device (the full-width run
    is chip_smoke.py's tp phase)."""
    import torch_tp_ranks as R
    from repro_torch.launch import mesh as meshmod
    ranks = meshmod.spawn(R.cuda_world, "model=2", device="cuda",
                          timeout_s=300.0)
    assert ranks[0] == ranks[1]
    cfg, params = R.model("tinyllama-1.1b", "trunc2x2", cuda_dev,
                          attn_impl="flash")
    one = R.serve(cfg, params, device=cuda_dev)
    assert ranks[0]["done"] == one["done"]
    assert ranks[0]["stats"]["mesh"] == {"data": 1, "model": 2}

