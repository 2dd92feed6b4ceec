"""repro_torch's CUDA kernels against their plain PyTorch versions on the
card.  Marked `cuda`: they skip on a machine without a CUDA device.  This
file imports no JAX, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.approx import gemm as G
from repro_torch.core import multipliers as mm
from repro_torch.core import netlist as nl
from repro_torch.kernels import approx_qgemm as qk
from repro_torch.kernels import flash_attention as fk
from repro_torch.kernels import ops
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
