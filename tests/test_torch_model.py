"""The slice as a whole: reduced TinyLlama (f32, flash attention) through
repro_torch's model API against the JAX package's, on the same params.

Params come from `repro.models.api.init_params`, go through numpy into
`repro_torch.models.weights.from_reference`; prompts come from numpy.  The
JAX side runs jitted with `kernel_policy="pallas"` (its Pallas kernels in
interpret mode), the port on the CPU (each kernel's plain version).

Tolerance for logits: rtol=atol=1e-5.  The GEMMs are integer and
bit-exact on both sides; what differs is f32 rounding in the ops both
packages leave to their frameworks (rsqrt in rmsnorm, sin/cos in RoPE, exp
in softmax, reduction order in attention and in the exact-spec float
matmuls), a few ulps per op, which reaches the logits at ~1e-6.  An int8
activation pushed across a rounding boundary by such an ulp would show up
as a ~1e-3 jump and fail the test, so the tolerance does not hide one.
Greedy token ids must be identical.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro import configs as jconfigs
from repro.models import api as japi
from repro.models import common as JC
from repro_torch import configs
from repro_torch.models import api, common as C, weights

TOL = 1e-5
MAX_LEN = 24

# Pin torch's CPU pool: the test workers share the cores, and a fixed
# thread count keeps the order of CPU reductions the same everywhere.
torch.set_num_threads(1)


def _cfgs(mult, arch="tinyllama-1.1b"):
    over = dict(mult=mult, kernel_policy="pallas", attn_impl="flash")
    return (jconfigs.reduced(jconfigs.get_config(arch), **over),
            configs.reduced(configs.get_config(arch), **over))


@pytest.mark.parametrize("arch,mult", [
    pytest.param("tinyllama-1.1b", "trunc2x2", id="trunc2x2"),
    pytest.param("tinyllama-1.1b", "exact", id="exact"),
    # the other dense configs: QKV biases (qwen), a second vocabulary and
    # head layout (mistral)
    pytest.param("qwen1.5-32b", "trunc2x2", id="qwen1.5-32b-trunc2x2"),
    pytest.param("mistral-large-123b", "trunc2x2",
                 id="mistral-large-123b-trunc2x2"),
    # the GELU MLP with biases (w_up/mb_up, w_down/mb_down)
    pytest.param("starcoder2-7b", "trunc2x2", id="starcoder2-7b-trunc2x2"),
])
def test_prefill_and_decode_match_jax(arch, mult):
    cj, ct = _cfgs(mult, arch)
    pj = japi.init_params(cj, jax.random.key(0))
    sj = japi.make_spec(cj)
    pjp = japi.prepare_params(pj, cj, sj)
    params = weights.from_reference(
        jax.tree_util.tree_map(np.asarray, pj), ct, "cpu")
    st = api.make_spec(ct, device="cpu")
    ptp = api.prepare_params(params, ct, st)

    rng = np.random.default_rng(0)
    toks = rng.integers(0, ct.vocab, (2, 16)).astype(np.int32)
    true_len = np.array([16, 11], np.int32)
    pre = jax.jit(lambda p, t, n: japi.prefill(p, t, cj, sj, max_len=MAX_LEN,
                                               true_len=n))
    dec = jax.jit(lambda p, c, t: japi.decode_step(p, c, t, cj, sj))

    lj, cj_cache = pre(pjp, jnp.asarray(toks), jnp.asarray(true_len))
    lt, ct_cache = api.prefill(ptp, torch.from_numpy(toks).long(), ct, st,
                               max_len=MAX_LEN,
                               true_len=torch.from_numpy(true_len))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=TOL,
                               atol=TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(ct_cache[key].numpy(),
                                   np.asarray(cj_cache[key]), rtol=TOL,
                                   atol=TOL)
    np.testing.assert_array_equal(ct_cache["length"].numpy(), true_len)
    tj = np.asarray(jnp.argmax(lj, -1))
    tt = lt.argmax(-1).numpy()
    np.testing.assert_array_equal(tt, tj)
    for _ in range(3):
        lj, cj_cache = dec(pjp, cj_cache, jnp.asarray(tj[:, None], jnp.int32))
        lt, ct_cache = api.decode_step(ptp, ct_cache,
                                       torch.from_numpy(tt[:, None]).long(),
                                       ct, st)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=TOL,
                                   atol=TOL)
        tj = np.asarray(jnp.argmax(lj[:, -1], -1))
        tt = lt[:, -1].argmax(-1).numpy()
        np.testing.assert_array_equal(tt, tj)
    np.testing.assert_array_equal(ct_cache["length"].numpy(), true_len + 3)


def test_prepared_params_are_bit_identical_to_raw():
    _, ct = _cfgs("trunc2x2")
    params = api.init_params(ct, seed=3, device="cpu")
    spec = api.make_spec(ct, device="cpu")
    prepared = api.prepare_params(params, ct, spec)
    assert api.prepare_params(prepared, ct, spec)["lm_head"] is \
        prepared["lm_head"]
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, ct.vocab, (1, 9)))
    a, _ = api.prefill(params, toks, ct, spec, max_len=12)
    b, _ = api.prefill(prepared, toks, ct, spec, max_len=12)
    assert torch.equal(a, b)
    # ModelConfig.param_count leaves out the final norm
    assert api.param_count(params) == ct.param_count() + ct.d_model


def test_common_ops_match_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 4, 32)).astype(np.float32)
    pos = np.arange(5)[None, :].repeat(2, 0)
    np.testing.assert_allclose(
        C.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4).numpy(),
        np.asarray(JC.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4)),
        rtol=1e-5, atol=1e-6)
    h = rng.standard_normal((3, 7, 64)).astype(np.float32)
    s = rng.standard_normal((64,)).astype(np.float32) * 0.1
    np.testing.assert_allclose(
        C.rmsnorm(torch.from_numpy(h), torch.from_numpy(s)).numpy(),
        np.asarray(JC.rmsnorm(jnp.asarray(h), jnp.asarray(s))),
        rtol=1e-6, atol=1e-6)
    q = rng.standard_normal((2, 1, 4, 32)).astype(np.float32)
    kc = rng.standard_normal((2, 10, 2, 32)).astype(np.float32)
    vc = rng.standard_normal((2, 10, 2, 32)).astype(np.float32)
    ln = np.array([3, 10], np.int32)
    np.testing.assert_allclose(
        C.decode_attention(*map(torch.from_numpy, (q, kc, vc, ln))).numpy(),
        np.asarray(JC.decode_attention(*map(jnp.asarray, (q, kc, vc, ln)))),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("causal", [True, False])
def test_attention_impls_agree(causal):
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 40, n, 32)).astype(
        np.float32)) for n in (4, 2, 2))
    naive = C.naive_attention(q, k, v, causal)
    for impl in ("chunked", "flash"):
        got = C.attention(q, k, v, impl=impl, chunk=16, causal=causal,
                          policy="pallas")
        torch.testing.assert_close(got, naive, rtol=2e-6, atol=6e-6)
    want = JC.naive_attention(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                              causal)
    np.testing.assert_allclose(naive.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_cache_helpers():
    cache = torch.zeros((2, 4, 1))
    C.rowwise_cache_update(cache, torch.ones((2, 1, 1)),
                           torch.tensor([1, 7]))
    assert cache[0, 1, 0] == 1 and cache[1, 3, 0] == 1     # clamped
    h = torch.arange(12.).reshape(1, 6, 2).repeat(2, 1, 1)
    out = C.last_valid_slice(h, torch.tensor([2, 6]))
    assert out.shape == (2, 1, 2) and out[0, 0, 0] == 2 and out[1, 0, 0] == 10
    assert C.prefill_length(None, 5).item() == 5
    assert C.cache_lengths({"length": torch.tensor(3)}, 2).tolist() == [3, 3]


def test_unported_families_raise():
    """Only a family the port does not know raises: every config of the
    repo initialises and builds its cache, the MoE ones (grok-1,
    llama4-maverick: tests/test_torch_moe.py) included."""
    import dataclasses
    cfg = configs.reduced(configs.get_config("tinyllama-1.1b"))
    with pytest.raises(NotImplementedError, match="not ported"):
        api.init_params(dataclasses.replace(cfg, family="vlm"),
                        device="cpu")
    for arch in configs.ARCH_IDS:
        cfg = configs.reduced(configs.get_config(arch))
        params = api.init_params(cfg, device="cpu")
        assert api.param_count(params) > 0, arch
        cache = api.init_cache(cfg, 1, 8, device="cpu")
        assert "length" in cache and len(cache) > 1, arch
