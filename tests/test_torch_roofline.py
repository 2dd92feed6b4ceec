"""The port's roofline (`repro_torch.roofline.analysis`) on the CPU.

- `kernel_bound` reproduces the "Bound ms" column of PERF.md's kernel
  table from the shapes of each row's unit, and is the larger of its
  two terms for every kernel;
- the analytic cell terms (`RooflineTerms`, `model_flops_for_cell`,
  `kernel_io_bytes_for_cell`, `analytic_memory_per_device`) equal the JAX
  package's on every config and SHAPES cell, rated on `V5E`, the JAX
  package's TPU constants.
"""

import pytest

from repro import configs as jconfigs
from repro.roofline import analysis as janalysis
from repro_torch import configs
from repro_torch.models import cnn
from repro_torch.roofline import analysis as rfa

REL = 1e-12


def _tinyllama():
    cfg = configs.get_config("tinyllama-1.1b")
    d, f, kvd = cfg.d_model, cfg.d_ff, cfg.n_kv_heads * cfg.hd
    layer = [(d, d), (d, kvd), (d, kvd), (d, d), (d, f), (d, f), (f, d)]
    return cfg, layer


def _vgg16_convs(batch=8, image=224):
    shapes, c_in, hw = [], 3, image
    for v in cnn.VGG_CFG["vgg16"]:
        if v == "M":
            hw //= 2
            continue
        shapes.append((batch * hw * hw, 9 * c_in, v))
        c_in = v
    return shapes


def _table_units():
    """Each kernel-table row's unit as (kernel, shapes of its calls)."""
    cfg, layer = _tinyllama()
    d, n_layers = cfg.d_model, cfg.n_layers
    convs = _vgg16_convs()
    planes = 6                          # pareto:0.01: rank 5
    return {
        "1a": ("quantize_rows",         # decode step, m = 4: 155 calls
               [(4, k) for _ in range(n_layers) for k, _ in layer]
               + [(4, d)]),
        "1b": ("quantize_rows",         # VGG16 forward: 16 calls
               [(m, k) for m, k, _ in convs]
               + [(8, 25088), (8, 4096), (8, 4096)]),
        "2": ("approx_qgemm_plane0",    # prefill, M = 128: 154 calls
              [(128, k, n) for _ in range(n_layers) for k, n in layer]),
        "3": ("approx_qgemm_skinny",    # decode step, m = 4: 155 calls
              [(4, k, n) for _ in range(n_layers) for k, n in layer]
              + [(4, d, cfg.vocab)]),
        "4": ("flash_attention",        # prefill, s = 128: 22 calls
              [(cfg.n_heads, 128, 128, cfg.hd)] * n_layers),
        "5": ("approx_qgemm_fused",     # VGG16's 13 conv GEMMs
              [(m, k, n, planes) for m, k, n in convs]),
        "6": ("approx_qgemm_stacked",   # the same on pre-mapped stacks
              [(m, k, n, planes) for m, k, n in convs]),
    }


#: PERF.md §6's "Bound ms" column (regenerated with kernel_bound) and
#: what bounds each row.
TABLE = {"1a": (0.002367, "bytes"), "1b": (0.9777, "bytes"),
         "2": (0.3645, "bytes"), "3": (0.3113, "bytes"),
         "4": (0.02755, "bytes"), "5": (0.7445, "operations"),
         "6": (1.327, "bytes")}


@pytest.mark.parametrize("row", sorted(TABLE))
def test_kernel_bound_reproduces_the_kernel_table(row):
    kernel, shapes = _table_units()[row]
    sec, by = rfa.kernel_bound(kernel, shapes)
    assert sec * 1e3 == pytest.approx(TABLE[row][0], rel=1e-2)
    assert by == TABLE[row][1]


def test_kernel_bound_counts_each_byte_once():
    """Row 2's figure, by hand: A, B and the f32 output once each."""
    _, shapes = _table_units()["2"]
    nbytes = sum(m * k + k * n + 4 * m * n for m, k, n in shapes)
    assert rfa.kernel_bound("approx_qgemm_plane0", shapes) == \
        pytest.approx((nbytes / 3.35e12, "bytes"), rel=REL)
    # causal pairs: s (s + 1) / 2 at sq = skv, all s^2 without the mask
    assert rfa.kernel_work("flash_attention", [(1, 128, 128, 64)])[1] == \
        4 * 64 * 128 * 129 // 2
    assert rfa.kernel_work("flash_attention",
                           [(1, 128, 128, 64, False)])[1] == 4 * 64 * 128 ** 2
    _, _, dtype = rfa.kernel_work("flash_attention",
                                  [(1, 128, 128, 64, True, 2)])
    assert dtype == "bf16"
    with pytest.raises(ValueError, match="unknown kernel"):
        rfa.kernel_work("approx_qgemm", [(1, 1, 1)])


#: One small and one large call of each kernel, in its shape convention.
CALLS = {"quantize_rows": [(4, 2048), (401408, 576)],
         "flash_attention": [(32, 1, 512, 64), (32, 2048, 2048, 128)],
         "approx_qgemm_plane0": [(128, 2048, 256), (4096, 8192, 8192)],
         "approx_qgemm_skinny": [(4, 2048, 2048), (32, 8192, 8192, 6)],
         "approx_qgemm_fused": [(8, 27, 64, 6), (6272, 4608, 512, 6)],
         "approx_qgemm_stacked": [(8, 27, 64, 6), (6272, 4608, 512, 6)]}


@pytest.mark.parametrize("chip", [rfa.H100_SXM, rfa.V5E],
                         ids=lambda c: c.name)
@pytest.mark.parametrize("kernel", rfa.KERNELS)
def test_kernel_bound_is_the_larger_term(kernel, chip):
    """Bytes over the HBM rate against operations over the operand
    type's peak, per call and summed over calls: the bound of a list of
    calls is that of their summed work, and a repeated list doubles it."""
    for shapes in ([CALLS[kernel][0]], [CALLS[kernel][1]], CALLS[kernel]):
        nbytes, ops, dtype = rfa.kernel_work(kernel, shapes)
        tb, to = nbytes / chip.hbm_bytes_per_s, ops / chip.peak(dtype)
        sec, by = rfa.kernel_bound(kernel, shapes, chip)
        assert sec == max(tb, to) and by == ("bytes" if tb >= to
                                             else "operations")
        assert rfa.kernel_bound(kernel, shapes * 2, chip)[0] == \
            pytest.approx(2 * sec, rel=REL)


# --- the cell terms against the JAX package's ---------------------------------

MESHES = [{}, {"model": 4}, {"data": 8, "model": 4},
          {"pod": 2, "data": 4, "model": 8}]


def _close(a, b):
    if isinstance(a, dict):
        assert set(a) >= set(b)
        for key in b:
            _close(a[key], b[key])
    elif isinstance(a, str):
        assert a == b
    else:
        assert a == pytest.approx(b, rel=REL, abs=0.0)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_cell_terms_equal_the_jax_package(arch):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    assert set(configs.SHAPES) == set(jconfigs.SHAPES)
    for name, shape in configs.SHAPES.items():
        jshape = jconfigs.SHAPES[name]
        assert (shape.seq_len, shape.global_batch, shape.kind) == \
            (jshape.seq_len, jshape.global_batch, jshape.kind)
        flops = rfa.model_flops_for_cell(cfg, shape)
        _close(flops, janalysis.model_flops_for_cell(jcfg, jshape))
        io = rfa.kernel_io_bytes_for_cell(cfg, shape)
        _close(io, janalysis.kernel_io_bytes_for_cell(jcfg, jshape))
        for mesh in MESHES:
            for kw in ({}, {"accum": 2, "fsdp": True},
                       {"fsdp": False, "moment_bytes": 2.0}):
                _close(rfa.analytic_memory_per_device(cfg, shape, mesh, **kw),
                       janalysis.analytic_memory_per_device(jcfg, jshape,
                                                            mesh, **kw))
        # the terms of a cell rated on the JAX package's TPU constants
        fields = dict(flops=3.0 * flops, hbm_bytes=7.0 * io + 1e9,
                      collective_bytes=flops / 1e3,
                      collectives={"all-reduce": flops / 1e3}, chips=8,
                      model_flops=flops, tagged_bytes=2.0 * io,
                      kernel_io_bytes=io)
        got = rfa.RooflineTerms(**fields, chip=rfa.V5E).as_dict()
        want = janalysis.RooflineTerms(**fields).as_dict()
        _close(got, want)
        assert got["chip"] == "TPU v5e"


def test_terms_rate_the_card_by_default():
    t = rfa.RooflineTerms(flops=1e18, hbm_bytes=1e15, collective_bytes=1e14,
                          collectives={}, chips=4, model_flops=5e17)
    assert t.chip is rfa.H100_SXM
    assert t.compute_s == pytest.approx(1e18 / (4 * 989e12), rel=REL)
    assert t.memory_s == pytest.approx(1e15 / (4 * 3.35e12), rel=REL)
    assert t.collective_s == pytest.approx(1e14 / (4 * 450e9), rel=REL)
    assert t.bottleneck == "compute"
