"""repro_torch's `quantize_rows`: its plain version against the JAX
package's kernel on non-finite and degenerate rows, and the CUDA kernel's
launch plan (`quantize.launch_plan`) at every (M, K) the main paths give it.

The JAX kernel runs as the JAX package's own tests run it on the CPU
(interpret mode through `repro.kernels.ops`).  Codes and scales are
compared bit for bit, NaN payloads included.  The kernel itself is held
against the plain version on the card by tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import quantize as qz

torch.set_num_threads(1)


def _special_rows(case: str) -> np.ndarray:
    """Four rows of 37: row 1 holds the case, the others are ordinary."""
    x = np.random.default_rng(5).standard_normal((4, 37)).astype(np.float32)
    x *= 3
    row = x[1]
    if case == "nan":
        row[3] = np.nan
    elif case == "neg_nan":
        row[3] = -np.nan
    elif case == "pos_inf":
        row[5] = np.inf
    elif case == "neg_inf":
        row[7] = -np.inf
    elif case == "nan_and_inf":
        row[2], row[30] = np.inf, np.nan
    elif case == "zeros":
        row[:] = 0
    elif case == "below_floor":
        row *= np.float32(1e-10)
    return x


CASES = ["nan", "neg_nan", "pos_inf", "neg_inf", "nan_and_inf", "zeros",
         "below_floor"]


@pytest.mark.parametrize("trunc", [0, 2])
@pytest.mark.parametrize("case", CASES)
def test_quantize_rows_plain_matches_jax_on_special_rows(case, trunc):
    x = _special_rows(case)
    q_j, s_j = jops.quantize_rows(jnp.asarray(x), trunc=trunc)
    q_t, s_t = qz.quantize_rows_plain(torch.from_numpy(x), trunc)
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s_t.numpy().view(np.uint32),
                                  np.asarray(s_j).view(np.uint32))
    # the contract the CUDA kernel is held to on the card
    s, q = s_t.numpy()[1, 0], q_t.numpy()[1]
    if "nan" in case:
        assert np.isnan(s) and not q.any()
    elif "inf" in case:
        assert s == np.inf and not q.any()
    else:                   # the floor: coarse codes, none for zeros
        assert s == np.float32(1e-8) * np.float32(1 / 127)
        assert q.any() == (case == "below_floor")


# --- the launch plan ---------------------------------------------------------

def vgg16_shapes(batch: int = 8, image: int = 224) -> list[tuple[int, int]]:
    """(M, K) of VGG16's 16 quantized GEMM inputs: 13 im2col convs, 3 FCs."""
    cfg = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
           "M", 512, 512, 512, "M"]
    shapes, c_in, hw = [], 3, image
    for v in cfg:
        if v == "M":
            hw //= 2
            continue
        shapes.append((batch * hw * hw, 9 * c_in))
        c_in = v
    return shapes + [(batch, 512 * hw * hw), (batch, 4096), (batch, 4096)]


def resnet50_shapes(batch: int = 8, image: int = 224
                    ) -> list[tuple[int, int]]:
    """(M, K) of ResNet50's 54 quantized GEMM inputs (`cnn.resnet_forward`:
    the stem, c1/c2/c3 of 16 bottlenecks, 4 projections, the FC)."""
    hw = image // 2
    shapes = [(batch * hw * hw, 7 * 7 * 3)]
    hw = -(-hw // 2)                                   # SAME max-pool
    c_in = 64
    for stage, (blocks, w) in enumerate(zip([3, 4, 6, 3],
                                            [64, 128, 256, 512])):
        for b in range(blocks):
            stride = 2 if stage > 0 and b == 0 else 1
            out = -(-hw // stride)
            m = batch * out * out
            shapes += [(m, c_in), (m, 9 * w), (m, w)]
            if b == 0:
                shapes.append((m, c_in))
            hw, c_in = out, 4 * w
    return shapes + [(batch, c_in)]


def test_shape_lists_match_the_launch_counts():
    assert len(vgg16_shapes()) == 16 and len(resnet50_shapes()) == 54
    assert vgg16_shapes()[0] == (401408, 27)
    assert vgg16_shapes()[13] == (8, 25088)


TINYLLAMA = [(m, k) for m in (1, 4, 128) for k in (2048, 5632)]
ODD = [(33, 257), (3, 7), (5, 27), (33, 2049), (1, 1), (7, 32768),
       (3, 32769), (2, 40000), (3, 40001), (2, 20479), (2, 20481)]
MAIN_PATHS = sorted(set(TINYLLAMA + vgg16_shapes() + vgg16_shapes(2)
                        + resnet50_shapes() + resnet50_shapes(2)))


def _loads_per_element(plan: qz.QuantPlan, k: int) -> np.ndarray:
    """How often one row's elements are loaded under `plan`: lane l of the
    row's group takes units j * lanes + l (csrc/quantize.cu), a unit being a
    float4 in the 16-byte variant and one scalar in the scalar variant;
    j < vecs (or 4 * vecs scalars), or up to the row's end in the two-pass
    loop (vecs 0)."""
    n = k // 4 if plan.vec else k
    per_lane = plan.vecs * (1 if plan.vec else 4) if plan.vecs else \
        -(-n // plan.lanes)
    units = (np.arange(per_lane)[:, None] * plan.lanes
             + np.arange(plan.lanes)[None, :]).ravel()
    units = units[units < n]
    elems = (4 * units[:, None] + np.arange(4)).ravel() if plan.vec \
        else units
    counts = np.zeros(k, np.int64)
    np.add.at(counts, elems, 1)
    return counts


@pytest.mark.parametrize("m,k", MAIN_PATHS + ODD)
def test_launch_plan_covers_every_element_once(m, k):
    plan = qz.launch_plan(m, k)
    assert plan.vec == (k % 4 == 0)
    assert qz.MIN_LANES <= plan.lanes <= qz.MAX_LANES
    assert plan.lanes & (plan.lanes - 1) == 0
    assert plan.threads % 32 == 0 and plan.threads <= qz.MAX_LANES
    assert plan.threads % plan.lanes == 0
    rows = plan.threads // plan.lanes
    assert (plan.blocks - 1) * rows < m <= plan.blocks * rows
    if -(-k // 4) > qz.MAX_LANES * qz.MAX_VECS[plan.vec]:
        assert plan.vecs == 0 and plan.lanes == plan.threads
    else:
        # the row fits the register template: every element in a register
        assert 1 <= plan.vecs <= qz.MAX_VECS[plan.vec]
        assert plan.vecs * plan.lanes * 4 >= k
    np.testing.assert_array_equal(_loads_per_element(plan, k), 1)


def test_launch_plan_at_the_main_paths_classes():
    """No main-path shape needs the two-pass loop; short rows share a
    warp, and the decode rows and VGG16's FC 1 take one block per row."""
    assert all(qz.launch_plan(m, k).vecs > 0 for m, k in MAIN_PATHS)
    assert qz.launch_plan(401408, 27).lanes < 32
    for m, k in [(4, 2048), (4, 5632), (1, 2048), (8, 25088)]:
        plan = qz.launch_plan(m, k)
        assert plan.lanes == plan.threads and plan.blocks == m, plan


@pytest.mark.parametrize("m,k,ld,base,vec", [
    (4, 2048, None, 0, True),
    (4, 2048, 2052, 256, True),         # a row slice of a wider matrix
    (4, 2048, None, 4, False),          # base off the 16-byte grid
    (4, 2048, 2049, 0, False),          # row stride off the grid
    (401408, 27, None, 0, False),       # K % 4 != 0
    (33, 257, None, 0, False),
    (3, 7, None, 0, False),
])
def test_launch_plan_routes_unaligned_rows_to_scalar_loads(m, k, ld, base,
                                                           vec):
    plan = qz.launch_plan(m, k, ld, base)
    assert plan.vec is vec
    assert plan[1:] == qz.launch_plan(m, k)[1:]     # same lanes and blocks
