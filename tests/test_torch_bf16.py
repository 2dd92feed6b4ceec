"""bf16 models: the port's reduced TinyLlama in bfloat16 against the JAX
package's, evaluated eagerly (`jax.disable_jit()`), on the same params.

The port rounds bf16 where the reference does: SiLU as XLA expands
`jax.nn.silu` (`x * (1 / (1 + exp(-x)))`, every op rounded to bf16), and
the decode attention's query scale rounded to bf16 before the multiply,
as JAX rounds a weakly typed Python scalar.  With both, the logits are
bit-exact through prefill and 8 decode steps under a truncation and a
low-rank multiplier, and every greedy token is equal.

Eager, not jitted, JAX is the target: under jit XLA keeps the bf16
quantizer scale in f32 (excess precision), so no bf16 implementation can
match jitted JAX bit for bit (ROADMAP.md Queue 3).  Both sides run the
plain path (`kernel_policy="xla"`) and the chunked attention.
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

MAX_LEN = 32
DECODE_STEPS = 8

torch.set_num_threads(1)


def _bf16(x: np.ndarray):
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("mult", ["trunc2x2", "pareto:0.01"])
def test_bf16_tinyllama_bitexact_with_eager_jax(mult):
    over = dict(mult=mult, kernel_policy="xla", attn_impl="chunked",
                dtype="bfloat16")
    cj = jconfigs.reduced(jconfigs.get_config("tinyllama-1.1b"), **over)
    ct = configs.reduced(configs.get_config("tinyllama-1.1b"), **over)
    pj = japi.init_params(cj, jax.random.key(0))
    params = weights.from_reference(
        jax.tree_util.tree_map(np.asarray, pj), ct, "cpu")
    assert params["embed"].dtype == torch.bfloat16
    sj, st = japi.make_spec(cj), api.make_spec(ct, device="cpu")

    toks = np.random.default_rng(0).integers(0, 512, (4, 16)).astype(
        np.int32)
    true_len = np.array([16, 11, 7, 13], np.int32)
    with jax.disable_jit():
        pjp = japi.prepare_params(pj, cj, sj)
        lj, cache_j = japi.prefill(pjp, jnp.asarray(toks), cj, sj,
                                   max_len=MAX_LEN,
                                   true_len=jnp.asarray(true_len))
    ptp = api.prepare_params(params, ct, st)
    lt, cache_t = api.prefill(ptp, torch.from_numpy(toks).long(), ct, st,
                              max_len=MAX_LEN,
                              true_len=torch.from_numpy(true_len))
    assert lt.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(lt), _np(lj), err_msg="prefill")
    tj = np.asarray(jnp.argmax(lj, -1))
    tt = lt.argmax(-1).numpy()
    np.testing.assert_array_equal(tt, tj)
    for step in range(DECODE_STEPS):
        with jax.disable_jit():
            lj, cache_j = japi.decode_step(
                pjp, cache_j, jnp.asarray(tj[:, None], jnp.int32), cj, sj)
        lt, cache_t = api.decode_step(ptp, cache_t,
                                      torch.from_numpy(tt[:, None]).long(),
                                      ct, st)
        np.testing.assert_array_equal(_np(lt), _np(lj),
                                      err_msg=f"decode step {step + 1}")
        tj = np.asarray(jnp.argmax(lj[:, -1], -1))
        tt = lt[:, -1].argmax(-1).numpy()
        np.testing.assert_array_equal(tt, tj)
    np.testing.assert_array_equal(cache_t["length"].numpy(),
                                  true_len + DECODE_STEPS)


def test_bf16_silu_rounds_as_jax():
    """The SwiGLU gate's SiLU in bf16 equals `jax.nn.silu` bit for bit on
    10^5 samples; in f32 the port keeps `F.silu`."""
    x = np.random.default_rng(0).standard_normal(100_000).astype(
        np.float32) * 4
    xj, xt = _bf16(x)
    np.testing.assert_array_equal(_np(C.silu(xt)), _np(jax.nn.silu(xj)))
    xf = torch.from_numpy(x)
    assert torch.equal(C.silu(xf), torch.nn.functional.silu(xf))


def test_bf16_decode_attention_matches_jax():
    """decode_attention in bf16 at head dim 32: the query scale rounds to
    bf16 (0.17675781) before the multiply, as in JAX."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 1, 4, 32)).astype(np.float32)
    kc = rng.standard_normal((2, 10, 2, 32)).astype(np.float32)
    vc = rng.standard_normal((2, 10, 2, 32)).astype(np.float32)
    ln = np.array([3, 10], np.int32)
    (qj, qt), (kj, kt), (vj, vt) = _bf16(q), _bf16(kc), _bf16(vc)
    got = C.decode_attention(qt, kt, vt, torch.from_numpy(ln))
    with jax.disable_jit():
        want = JC.decode_attention(qj, kj, vj, jnp.asarray(ln))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), _np(want))
