"""repro_torch's conv2d, CNN models and accuracy entry point against the JAX
package.

Inputs and parameters are made with numpy (or by the JAX initialisers) and
handed to both packages.  The JAX side runs jitted, as it serves; its
"pallas" policy runs the Pallas kernels in interpret mode, and the port's
runs the kernel wrappers' plain versions on the CPU.  Tolerances:

* exact (float) convolution: F.conv2d vs XLA's convolution, which sum in
  different orders — rtol 1e-5 against the output's scale;
* truncation multipliers: bit-exact (the im2col patches are the same
  copies, every int8 code agrees, the integer GEMM is exact);
* low-rank multipliers: rtol 1e-6, atol 1e-6 on a GEMM, as
  tests/test_torch_gemm.py holds approx_matmul (XLA contracts the JAX
  flush into FMAs; ROADMAP Queue 3).  Through a model, a one-ulp
  difference may move an int8 code of the next layer by one where x/scale
  sits on a rounding boundary, so logits are held to rtol 1e-4 of their
  scale there.  ResNet's float steps between the GEMMs (the folded-BN
  affine, which XLA contracts into an FMA, and the spatial mean, summed in
  another order) round differently as well, so its logits are held that
  way under every multiplier.
"""

import functools
import importlib.util
import pathlib

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.approx import gemm as JG
from repro.approx import layers as JL
from repro.core import multipliers as jmm
from repro.core import netlist as jnl
from repro.core import pareto as jpareto
from repro.models import cnn as jcnn
from repro_torch.approx import gemm as G
from repro_torch.approx import layers as L
from repro_torch.core import multipliers as mm
from repro_torch.core import pareto
from repro_torch.launch import accuracy as acc
from repro_torch.models import cnn, weights

ROOT = pathlib.Path(__file__).resolve().parents[1]
RNG = np.random.default_rng(21)

# Pin torch's CPU pool: the test workers share the cores, and a fixed
# thread count keeps the order of CPU reductions the same everywhere.
torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _specs(name):
    """(JAX spec, port spec) of one multiplier."""
    if name == "lowrank4":
        mask = np.random.default_rng(4).random(
            len(jnl.bw8().prunable_gates())) < 0.03
        return (JG.from_multiplier(jmm.pruned(mask, name="tc4"), rank=4),
                G.from_multiplier(mm.pruned(mask, name="tc4"), rank=4))
    return JG.spec_from_name(name), G.spec_from_name(name)


@pytest.fixture(scope="module")
def small_front(tmp_path_factory):
    """Both packages' "pareto:<band>" names resolved on a pop 12 x 4
    generation NSGA-II front (the default 56 x 44 costs ~15 s a package),
    each cached in its own temporary directory."""
    small = dict(pop_size=12, generations=4, seed=0)
    j_front, t_front = jpareto.default_front, pareto.default_front
    tmp = tmp_path_factory.mktemp("fronts")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpareto, "_CACHE_DIR", tmp / "jax")
        mp.setattr(jpareto, "default_front", lambda: j_front(**small))
        mp.setenv("REPRO_CACHE_DIR", str(tmp / "torch"))
        mp.setattr(pareto, "default_front", lambda: t_front(**small))
        yield
    t_front.cache_clear()


def _jit_model(fwd, arch, spec):
    return jax.jit(lambda p, x: fwd(p, x, arch, spec=spec))


# --- conv2d -------------------------------------------------------------------

GEOMETRIES = [(1, 1, 0), (1, 2, 0), (3, 1, 1), (3, 2, 1), (3, 1, 0),
              (7, 2, 3)]   # (kernel, stride, padding)


@pytest.mark.parametrize("name,policy", [
    ("exact", None), ("trunc2x2", "pallas"), ("trunc2x2", "xla"),
    ("lowrank4", "pallas"), ("lowrank4", "xla")])
@pytest.mark.parametrize("geom", GEOMETRIES)
def test_conv2d_matches_jax(geom, name, policy):
    k, stride, pad = geom
    x = RNG.standard_normal((2, 16, 16, 8)).astype(np.float32)
    w = (RNG.standard_normal((k, k, 8, 16)) * (k * k * 8) ** -0.5
         ).astype(np.float32)
    js, ts = _specs(name)
    if policy:
        js, ts = js.with_policy(policy), ts.with_policy(policy)
    want = np.asarray(jax.jit(lambda a, b: JL.conv2d(a, b, stride, pad, js))(
        jnp.asarray(x), jnp.asarray(w)))
    got = L.conv2d(_t(x), _t(w), stride, pad, ts).numpy()
    assert got.shape == want.shape
    scale = np.abs(want).max()
    if name == "exact":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)
    elif name.startswith("trunc"):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_im2col_patch_order_matches_jax():
    x = RNG.standard_normal((2, 9, 11, 3)).astype(np.float32)
    for r, s, stride, pad in [(3, 3, 1, 1), (7, 7, 2, 3), (1, 1, 2, 0)]:
        got, ho, wo = L._im2col(_t(x), r, s, stride, pad)
        want, jho, jwo = JL._im2col(jnp.asarray(x), r, s, stride, pad)
        assert (ho, wo) == (jho, jwo)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --- whole models ---------------------------------------------------------------

def _logit_close(got, want, rtol):
    """Equal bits at rtol 0, else within rtol of the logits' scale; the
    same top-1 either way."""
    if rtol:
        np.testing.assert_allclose(got, want, rtol=rtol,
                                   atol=rtol * np.abs(want).max())
    else:
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


VGG_RTOL = {"exact": 1e-5, "trunc2x2": 0, "pareto:0.01": 1e-4}
RESNET_RTOL = {"exact": 1e-5, "trunc2x2": 1e-4, "pareto:0.01": 1e-4}


@pytest.mark.parametrize("name", ["exact", "trunc2x2", "pareto:0.01"])
def test_vgg_mini_matches_jax(name, small_front):
    jp = jcnn.init_vgg("vgg_mini", jax.random.key(0), n_classes=10,
                       image=32)
    tp = weights.cnn_from_reference(jax.tree_util.tree_map(np.asarray, jp),
                                    device="cpu")
    x = RNG.standard_normal((2, 32, 32, 3)).astype(np.float32)
    js, ts = JG.spec_from_name(name), G.spec_from_name(name)
    if name.startswith("pareto"):
        assert ts.mode == js.mode == "lowrank" and ts.rank == js.rank
    want = np.asarray(_jit_model(jcnn.vgg_forward, "vgg_mini", js)(
        jp, jnp.asarray(x)))
    with torch.no_grad():
        got = cnn.vgg_forward(tp, _t(x), "vgg_mini",
                              spec=ts.with_policy("pallas")).numpy()
    assert got.shape == (2, 10) and np.isfinite(got).all()
    _logit_close(got, want, VGG_RTOL[name])


@pytest.mark.parametrize("name", ["exact", "trunc2x2", "pareto:0.01"])
def test_resnet_mini_matches_jax(name, small_front):
    jp = jcnn.init_resnet("resnet_mini", jax.random.key(1), n_classes=10)
    tp = weights.cnn_from_reference(jax.tree_util.tree_map(np.asarray, jp),
                                    device="cpu")
    x = RNG.standard_normal((2, 16, 16, 3)).astype(np.float32)
    js, ts = JG.spec_from_name(name), G.spec_from_name(name)
    want = np.asarray(_jit_model(jcnn.resnet_forward, "resnet_mini", js)(
        jp, jnp.asarray(x)))
    with torch.no_grad():
        got = cnn.resnet_forward(tp, _t(x), "resnet_mini",
                                 spec=ts.with_policy("pallas")).numpy()
    assert got.shape == (2, 10) and np.isfinite(got).all()
    _logit_close(got, want, RESNET_RTOL[name])


def test_resnet50_stem_and_same_pool_match_jax():
    """Full-width ResNet50 at 32x32, batch 1, float: the stride-2 7x7 stem
    and the 3x3 stride-2 SAME max-pool, which pads (0, 1) with -inf."""
    jp = jcnn.init_resnet("resnet50", jax.random.key(2), n_classes=1000)
    tp = weights.cnn_from_reference(jax.tree_util.tree_map(np.asarray, jp),
                                    device="cpu")
    assert len(tp["stages"]) == 4 and len(tp["stages"][2]) == 6
    x = RNG.standard_normal((1, 32, 32, 3)).astype(np.float32)
    want = np.asarray(_jit_model(jcnn.resnet_forward, "resnet50", None)(
        jp, jnp.asarray(x)))
    with torch.no_grad():
        got = cnn.resnet_forward(tp, _t(x), "resnet50").numpy()
    _logit_close(got, want, RESNET_RTOL["exact"])


def test_same_max_pool_pads_like_xla():
    x = RNG.standard_normal((2, 8, 7, 3)).astype(np.float32)
    want = jax.lax.reduce_window(jnp.asarray(x), -jnp.inf, jax.lax.max,
                                 (1, 3, 3, 1), (1, 2, 2, 1), "SAME")
    got = cnn._max_pool(_t(x), 3, 2, same=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_init_shapes_match_jax():
    """The port's initialisers build the JAX package's trees: the same
    nesting, the same shapes."""
    def shapes(tree):
        return jax.tree_util.tree_map(lambda a: tuple(a.shape), tree)

    assert shapes(cnn.init_vgg("vgg16", seed=0, image=32, device="cpu")) == \
        shapes(jcnn.init_vgg("vgg16", jax.random.key(0), image=32))
    assert shapes(cnn.init_resnet("resnet_mini", seed=0, device="cpu")) == \
        shapes(jcnn.init_resnet("resnet_mini", jax.random.key(0)))


# --- the accuracy entry point -------------------------------------------------

def _bench_accuracy():
    spec = importlib.util.spec_from_file_location(
        "bench_accuracy", ROOT / "benchmarks" / "bench_accuracy.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_accuracy_on_reference_trained_params():
    """The port's `accuracy` on parameters the JAX benchmark trained (20
    steps), on the first 128 held-out images: the same top-1 as the JAX
    network's, exact and under trunc2x2 and a rank-4 pruned multiplier."""
    ref = _bench_accuracy()
    jp = ref.train_small_cnn(steps=20)
    tp = weights.cnn_from_reference(jax.tree_util.tree_map(np.asarray, jp),
                                    device="cpu")
    n = 128
    x, y = acc.synthetic.shapes_classification(512, seed=1, **acc.TASK)
    for name in ("exact", "trunc2x2", "lowrank4"):
        js, ts = _specs(name)
        logits = _jit_model(jcnn.vgg_forward, "vgg_mini", js)(
            jp, jnp.asarray(x[:n]))
        want = float((np.asarray(logits).argmax(-1) == y[:n]).mean())
        got = acc.accuracy(tp, ts.with_policy("pallas"), n=n)
        assert got == want, (name, got, want)
    assert acc.ACC_DROP_NMED_COEF == ref.gamod.ACC_DROP_NMED_COEF
    assert acc.ACC_DROP_MRED_COEF == ref.gamod.ACC_DROP_MRED_COEF
    m = mm.get_multiplier("trunc3x3")
    assert acc.proxy_accuracy_drop(m) == ref.gamod.proxy_accuracy_drop(
        jmm.get_multiplier("trunc3x3"))


def test_accuracy_main_runs_on_cpu(capsys, monkeypatch, small_front):
    """The CLI end to end at a tiny size: train 3 steps, then one CSV line
    for the exact network and one for each multiplier (the Pareto ones on
    the small front), evaluated here on 32 of the 512 images."""
    monkeypatch.setattr(acc, "accuracy",
                        functools.partial(acc.accuracy, n=32))
    assert acc.main(["--device", "cpu", "--steps", "3",
                     "--kernel-policy", "pallas"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    names = [ln.split(",")[0] for ln in lines]
    assert names == ["accuracy_exact"] + [f"accuracy_{n}"
                                          for n in acc.MULTIPLIERS]
    for ln in lines[1:]:
        fields = dict(kv.split("=") for kv in ln.split(",")[2].split(";"))
        assert set(fields) == {"top1", "drop_pct", "proxy_pct", "nmed"}
        assert 0.0 <= float(fields["top1"]) <= 1.0
