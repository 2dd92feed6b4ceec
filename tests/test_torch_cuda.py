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
                                   (256, 576, 64), (33, 4608, 512)])
def test_cuda_fused_lowrank_bitexact_with_plain(cuda_dev, shape, rank):
    """Fused kernel vs its plain version at a padded K tail (K = 257,
    4608 is a tile multiple), and the stacked twin bit-identical to it."""
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
    got = qgemm.approx_qgemm_fused(ap, bp, spec.fu_q, spec.fv_q,
                                   ops.plane_scales(spec, 2, cuda_dev),
                                   k_valid=128)
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
