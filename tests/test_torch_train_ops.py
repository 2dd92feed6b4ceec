"""Training's building blocks, repro_torch against the JAX package on the
CPU: fake_quant and quantize_param_tree (bit-exact), softmax_xent, the
blockwise attention's custom backward against `jax.vjp` of the
reference's custom VJP, flash attention refusing autograd, remat, the
AdamW (f32 / bf16 / int8 moments) and Adafactor updates on the same
params and grads, and warmup_cosine; then the counterparts of
`tests/test_train_infra.py`'s optimizer tests.  The JAX side runs jitted
(XLA), inputs come from numpy seeds."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.approx import quant as jquant
from repro.models import attention as jatt
from repro.models import common as JC
from repro.train import optimizer as jopt
from repro_torch import configs
from repro_torch.approx import quant
from repro_torch.models import api, attention, common as C
from repro_torch.train import optimizer as opt

torch.set_num_threads(1)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


# --- quantization ------------------------------------------------------------

@pytest.mark.parametrize("axis", [None, 0, 1])
def test_fake_quant_bitexact(axis):
    x = np.random.default_rng(0).standard_normal((64, 96)).astype(np.float32)
    want = jax.jit(lambda a: jquant.fake_quant(a, axis))(x)
    got = quant.fake_quant(torch.from_numpy(x), axis)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_quantize_param_tree_bitexact():
    """Large >= 2-D float weights become {"q", "s"} leaves with the
    reference's codes and scales (per stack x output channel); embed,
    vectors and small matrices stay float."""
    rng = np.random.default_rng(1)
    tree = {"embed": rng.standard_normal((600, 512)),
            "layers": {"wq": rng.standard_normal((2, 512, 640)),
                       "ln1": rng.standard_normal((2, 512)),
                       "small": rng.standard_normal((64, 64))},
            "lm_head": rng.standard_normal((512, 600))}
    tree = jax.tree_util.tree_map(lambda a: a.astype(np.float32), tree)
    want = jax.jit(jquant.quantize_param_tree)(tree)
    got = quant.quantize_param_tree(
        jax.tree_util.tree_map(torch.from_numpy, tree))
    for name in ("embed",):
        assert torch.is_tensor(got[name])
    assert torch.is_tensor(got["layers"]["ln1"])
    assert torch.is_tensor(got["layers"]["small"])
    for leaf_t, leaf_j in ((got["layers"]["wq"], want["layers"]["wq"]),
                           (got["lm_head"], want["lm_head"])):
        assert quant.is_qweight(leaf_t)
        np.testing.assert_array_equal(leaf_t["q"].numpy(),
                                      np.asarray(leaf_j["q"]))
        np.testing.assert_array_equal(leaf_t["s"].numpy(),
                                      np.asarray(leaf_j["s"]))
    assert got["layers"]["wq"]["s"].shape == (2, 1, 640)


# --- loss --------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_softmax_xent_matches_jax(masked):
    rng = np.random.default_rng(2)
    logits = (rng.standard_normal((3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) < 0.6).astype(np.float32) if masked else None
    want = jax.jit(JC.softmax_xent)(logits, labels, mask)
    got = C.softmax_xent(torch.from_numpy(logits), torch.from_numpy(labels),
                         None if mask is None else torch.from_numpy(mask))
    assert abs(got.item() - float(want)) <= 1e-6 * abs(float(want))


def test_softmax_xent_empty_mask_is_zero():
    logits = torch.randn(2, 3, 5)
    got = C.softmax_xent(logits, torch.zeros(2, 3, dtype=torch.long),
                         torch.zeros(2, 3))
    assert got.item() == 0.0


# --- blockwise attention backward --------------------------------------------

ATTN_CASES = [
    # (sq, skv, heads, kv heads, chunk, causal, window)
    (32, 32, 4, 4, 8, True, 0),       # causal, 4 chunks
    (32, 32, 4, 4, 8, False, 0),      # non-causal
    (40, 40, 4, 2, 16, True, 32),     # windowed (the hybrid's branch), GQA
    (40, 40, 4, 2, 16, True, 0),      # GQA, s not a multiple of the chunk
    (12, 40, 4, 2, 16, False, 0),     # cross-attention across lengths
    (20, 20, 8, 2, 8, True, 6),       # window < chunk, GQA of 4
]


def _attn_inputs(sq, skv, h, kvh, seed=3):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((2, sq, h, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, skv, kvh, 16)).astype(np.float32)
            for _ in range(2))
    g = rng.standard_normal((2, sq, h, 16)).astype(np.float32)
    return q, k, v, g


@pytest.mark.parametrize("sq,skv,h,kvh,chunk,causal,window", ATTN_CASES)
def test_blockwise_attention_backward_matches_jax_vjp(sq, skv, h, kvh, chunk,
                                                      causal, window):
    q, k, v, g = _attn_inputs(sq, skv, h, kvh)

    def jvjp(q, k, v, g):
        out, pull = jax.vjp(lambda a, b, c: jatt.blockwise_attention(
            a, b, c, chunk, causal, window), q, k, v)
        return (out, *pull(g))

    want = jax.jit(jvjp)(q, k, v, g)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = attention.blockwise_attention(tq, tk, tv, chunk, causal, window)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    for got, w in zip((out, *grads), want):
        np.testing.assert_allclose(_np(got), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def test_blockwise_attention_forward_unchanged_without_grad():
    """Without autograd the plain forward runs: the same bits as the
    autograd path's output, nothing saved."""
    q, k, v, _ = _attn_inputs(40, 40, 4, 2)
    args = [torch.from_numpy(a) for a in (q, k, v)]
    plain = attention.blockwise_attention(*args, 16, True, 0)
    tracked = attention.blockwise_attention(
        *(a.clone().requires_grad_() for a in args), 16, True, 0)
    assert plain.grad_fn is None and tracked.grad_fn is not None
    assert torch.equal(plain, tracked.detach())


def test_flash_refuses_autograd_and_chunked_matches_naive():
    """The flash kernel has no backward (neither has the reference's): on
    the kernel path it raises for inputs that need a gradient, instead of
    returning a result without one.  The chunked attention's gradients
    equal autograd through the naive attention."""
    q, k, v, g = _attn_inputs(24, 24, 4, 2, seed=4)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    with pytest.raises(RuntimeError, match="no backward"):
        C.attention(tq, tk, tv, impl="flash", chunk=8, policy="pallas")
    with torch.no_grad():          # inference takes the kernel path still
        C.attention(tq, tk, tv, impl="flash", chunk=8, policy="pallas")
    gt = torch.from_numpy(g)
    got = torch.autograd.grad(
        C.attention(tq, tk, tv, impl="chunked", chunk=8), (tq, tk, tv), gt)
    want = torch.autograd.grad(C.naive_attention(tq, tk, tv), (tq, tk, tv),
                               gt)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_remat_gives_the_same_gradients():
    """`cfg.remat` reruns each block in the backward: the loss and every
    gradient are the same bits as without it (MoE aux included)."""
    for arch in ("tinyllama-1.1b", "grok-1-314b"):
        cfg = configs.reduced(configs.get_config(arch), mult="trunc2x2",
                              kernel_policy="pallas")
        params = api.init_params(cfg, 0, "cpu")
        toks = torch.from_numpy(
            np.random.default_rng(5).integers(0, cfg.vocab, (2, 16)))
        out = []
        for remat in (False, True):
            c = dataclasses.replace(cfg, remat=remat)
            leaves = {k: v.detach().requires_grad_()
                      for k, v in params["layers"].items()}
            p = dict(params, layers=leaves)
            loss, _ = api.loss_fn(p, {"tokens": toks}, c,
                                   api.make_spec(c, device="cpu"))
            out.append((loss, torch.autograd.grad(
                loss, list(leaves.values()))))
        assert torch.equal(out[0][0], out[1][0])
        for a, b in zip(out[0][1], out[1][1]):
            assert torch.equal(a, b)


# --- optimizers against the reference's updates ------------------------------

def _tree_np(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((6, 200)) * scale).astype(np.float32),
            "layers": {"a": (rng.standard_normal((2, 3, 130)) * scale
                             ).astype(np.float32),
                       "b": (rng.standard_normal((130,)) * scale
                             ).astype(np.float32)},
            "s": np.float32(scale * 0.3)}


def _to_t(tree, dtype=torch.float32):
    return jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dtype), tree)


def _leaves_close(got, want, tol):
    gl = opt.tree_leaves(got)
    wl = jax.tree_util.tree_leaves(want)
    assert len(gl) == len(wl)
    for a, b in zip(gl, wl):
        np.testing.assert_allclose(_np(a), np.asarray(b, np.float32),
                                   rtol=tol, atol=tol)


def _moment_leaves(st):
    """Leaves of a moment tree, `QMoment`s as (q, scale)."""
    out = []
    for x in opt.tree_leaves(st):
        out += [x.q, x.scale] if isinstance(x, opt.QMoment) else [x]
    return out


def _run_updates(kind, kw, grad_scales):
    """The reference's (jitted) and the port's optimizer over the same
    params and grads, one update per grad scale; yields both after each."""
    params = _tree_np(6)
    jinit, jupd = jopt.make_optimizer(kind, lr=1e-2, total_steps=20,
                                      warmup_steps=2, **kw)
    tinit, tupd = opt.make_optimizer(kind, lr=1e-2, total_steps=20,
                                     warmup_steps=2, **kw)
    pj, sj = params, jinit(params)
    pt = _to_t(params)
    st = tinit(pt)
    jstep = jax.jit(jupd)
    for i, gs in enumerate(grad_scales):
        g = _tree_np(7 + i, scale=gs)
        pj, sj = jstep(pj, g, sj)
        pt, st = tupd(pt, _to_t(g), st)
        assert int(st["step"]) == int(sj["step"])
        yield pt, st, pj, sj


@pytest.mark.parametrize("kind,kw", [
    ("adamw", {"moment_dtype": "f32"}),
    ("adamw", {"moment_dtype": "bf16"}),
    ("adamw", {"moment_dtype": "int8"}),
    ("adafactor", {}),
    ("adafactor", {"weight_decay": 0.1}),
])
def test_optimizer_updates_match_jax(kind, kw):
    """Three updates on the same params and grads as the reference's:
    params and moments within 1e-6; int8 moments' codes and block scales
    bit-exact (grads under the clip norm, so the clip scale is 1)."""
    for pt, st, pj, sj in _run_updates(kind, kw, (0.01, 0.02, 0.005)):
        _leaves_close(pt, pj, 1e-6)
        if kind == "adafactor":
            _leaves_close(st["f"], sj["f"], 1e-6)
            continue
        for name in ("m", "v"):
            got, want = _moment_leaves(st[name]), jax.tree_util.tree_leaves(
                sj[name])
            assert len(got) == len(want)
            for a, b in zip(got, want):
                b = np.asarray(b)
                if kw["moment_dtype"] == "int8":     # codes, block scales
                    assert a.dtype == torch.int8 or a.dtype == torch.float32
                    np.testing.assert_array_equal(a.numpy(), b)
                else:
                    np.testing.assert_allclose(_np(a), b.astype(np.float32),
                                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("moment_dtype", ["f32", "int8"])
def test_clipped_updates_match_jax(moment_dtype):
    """A first grad 30x past the clip norm: the clip bites, and params
    and dequantized moments stay within 1e-6 of the reference's (the
    global norm sums in another order, so the clip scale may move an
    ulp)."""
    for pt, st, pj, sj in _run_updates("adamw",
                                       {"moment_dtype": moment_dtype},
                                       (30.0, 0.5, 0.5)):
        _leaves_close(pt, pj, 1e-6)
        for name in ("m", "v"):
            got = [opt._load(x) for x in opt.tree_leaves(st[name])]
            want = jax.tree_util.tree_leaves(
                jax.tree_util.tree_map(jopt._QTensor.load, sj[name],
                                       is_leaf=lambda x: isinstance(
                                           x, jopt.QMoment)))
            for a, b in zip(got, want):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1e-6, atol=1e-6)


def test_bf16_params_update_like_jax():
    """bf16 params (f32 moments): the update runs in f32 and rounds the
    new params to bf16, as the reference's."""
    params = _tree_np(8)
    grads = _tree_np(9, scale=0.1)
    jinit, jupd = jopt.make_optimizer("adamw", lr=1e-2, warmup_steps=0)
    tinit, tupd = opt.make_optimizer("adamw", lr=1e-2, warmup_steps=0)
    pj = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                params)
    gj = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                grads)
    pj2, _ = jax.jit(jupd)(pj, gj, jinit(pj))
    pt = _to_t(params, torch.bfloat16)
    pt2, _ = tupd(pt, _to_t(grads, torch.bfloat16), tinit(pt))
    for a, b in zip(opt.tree_leaves(pt2), jax.tree_util.tree_leaves(pj2)):
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(a), np.asarray(b, np.float32),
                                   rtol=1e-2, atol=1e-6)


@pytest.mark.parametrize("step", [0, 1, 5, 9, 10, 11, 40, 99, 100, 150])
def test_warmup_cosine_matches_jax(step):
    want = jax.jit(lambda s: jopt.warmup_cosine(s, 3e-4, 10, 100))(
        jnp.asarray(step, jnp.int32))
    got = opt.warmup_cosine(torch.tensor(step, dtype=torch.int32), 3e-4, 10,
                            100)
    assert got.dtype == torch.float32
    assert abs(got.item() - float(want)) <= 1e-6 * 3e-4


def test_global_norm_matches_jax():
    tree = _tree_np(10, scale=3.0)
    want = float(jax.jit(jopt.global_norm)(tree))
    assert abs(opt.global_norm(_to_t(tree)).item() - want) <= 1e-6 * want


# --- counterparts of tests/test_train_infra.py's optimizer tests -------------

def _quad_problem():
    target = torch.from_numpy(
        np.random.default_rng(0).standard_normal((32, 64)).astype(np.float32))
    params = {"w": torch.zeros((32, 64))}

    def grads(p):
        return {"w": p["w"] - target}

    return params, grads, target


@pytest.mark.parametrize("kind,kw", [
    ("adamw", {"moment_dtype": "f32"}),
    ("adamw", {"moment_dtype": "bf16"}),
    ("adamw", {"moment_dtype": "int8"}),
    ("adafactor", {}),
])
def test_optimizer_converges_on_quadratic(kind, kw):
    params, grads, target = _quad_problem()
    init, update = opt.make_optimizer(
        kind, lr=0.05, total_steps=300, warmup_steps=10, weight_decay=0.0,
        **kw)
    st = init(params)
    for _ in range(300):
        params, st = update(params, grads(params), st)
    err = (params["w"] - target).abs().mean().item()
    assert err < 0.15, err


def test_quantized_moments_close_to_f32():
    params, grads, _ = _quad_problem()
    outs = {}
    for md in ("f32", "int8"):
        p = dict(params)
        init, update = opt.make_optimizer("adamw", lr=0.05, total_steps=100,
                                          warmup_steps=5, weight_decay=0.0,
                                          moment_dtype=md)
        st = init(p)
        for _ in range(50):
            p, st = update(p, grads(p), st)
        outs[md] = p["w"]
    rel = (outs["int8"] - outs["f32"]).abs().mean() / \
        (outs["f32"].abs().mean() + 1e-9)
    assert rel.item() < 0.05, rel


def test_grad_clip_applies():
    params = {"w": torch.zeros(4)}
    init, update = opt.make_optimizer("adamw", lr=1e-3, total_steps=10,
                                      warmup_steps=0)
    p2, _ = update(params, {"w": torch.full((4,), 1e6)}, init(params))
    assert torch.isfinite(p2["w"]).all()
    assert p2["w"].abs().max().item() < 1.0


def test_lr_schedule():
    lrs = [opt.warmup_cosine(torch.tensor(s), 1.0, 10, 100).item()
           for s in [0, 5, 10, 55, 100]]
    assert lrs[0] == 0.0
    assert lrs[1] == pytest.approx(0.5)
    assert lrs[2] == pytest.approx(1.0, abs=0.01)
    assert lrs[3] < lrs[2]
    assert lrs[4] == pytest.approx(0.1, abs=0.02)


def test_int8_moment_round_trip_keeps_shape_and_pad():
    x = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (3, 130)).astype(np.float32))
    st = opt._quantize_block(x)
    assert st.q.shape == (3, 256) and st.scale.shape == (3, 2)
    assert st.pad == 126 and st.shape == (3, 130)
    back = opt._dequantize_block(st)
    assert back.shape == x.shape
    assert (back - x).abs().max().item() <= x.abs().max().item() / 127
    scalar = opt._quantize_block(torch.tensor(2.5))
    assert scalar.shape == (1,) and opt._dequantize_block(scalar).item() == \
        pytest.approx(2.5, rel=1e-2)
