"""The `ssm` family (Mamba-2, SSD) of repro_torch against the JAX package's,
on the CPU at the reduced mamba2-370m with the SSD chunk cut to 8, so a
24-token prompt crosses three chunks (the reduced config keeps 256, which
a short prompt never reaches).

Params come from `repro.models.api.init_params` through
`weights.from_reference`; inputs from numpy.  The JAX side runs jitted,
the port on the CPU (each kernel's plain version), under trunc2x2 with
`kernel_policy="pallas"`.  Tolerance: rtol = atol = 1e-5 for logits and
cache leaves (tests/test_torch_model.py's), 1e-5 for the SSD's own
outputs.  The SSD's cumsums and einsums sum in another order than XLA's,
which moves results by ulps; an int8 code moved across a rounding
boundary would show as a ~1e-3 jump and fail.  Greedy tokens must be
identical.  The engine checks (tests/torch_engine_checks.py) hold the
slot and paged engines to lone decoding and to each other.
"""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import torch_engine_checks as E
from repro import configs as jconfigs
from repro.models import api as japi
from repro.models import common as JC
from repro.models import mamba2 as jm
from repro_torch import configs
from repro_torch.models import api, common as C, mamba2, weights

TOL = 1e-5
OVER = dict(mult="trunc2x2", kernel_policy="pallas", ssd_chunk=8)

torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _setup():
    cj = jconfigs.reduced(jconfigs.get_config("mamba2-370m"), **OVER)
    ct = configs.reduced(configs.get_config("mamba2-370m"), **OVER)
    pj = japi.init_params(cj, jax.random.key(0))
    pt = weights.from_reference(jax.tree_util.tree_map(np.asarray, pj), ct,
                                "cpu")
    return cj, ct, pj, pt


def _close(got: torch.Tensor, want, tol=TOL) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("init", [False, True])
def test_ssd_scan_matches_jax(init):
    """Three chunks of 8 (and a carried-in state)."""
    rng = np.random.default_rng(3)
    b, s, h, p, g, n = 2, 24, 4, 8, 1, 16
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dta = -rng.uniform(0.01, 0.5, (b, s, h)).astype(np.float32)
    B, Cm = (rng.standard_normal((b, s, g, n)).astype(np.float32)
             for _ in range(2))
    s0 = rng.standard_normal((b, h, p, n)).astype(np.float32) if init \
        else None
    yj, fj = jax.jit(jm.ssd_scan, static_argnums=4)(
        x, dta, B, Cm, 8, None if s0 is None else jnp.asarray(s0))
    yt, ft = mamba2.ssd_scan(*map(torch.from_numpy, (x, dta, B, Cm)), 8,
                             None if s0 is None else torch.from_numpy(s0))
    _close(yt, yj)
    _close(ft, fj)
    with pytest.raises(AssertionError):
        mamba2.ssd_scan(*map(torch.from_numpy, (x[:, :20], dta[:, :20],
                                                B[:, :20], Cm[:, :20])), 8)


def test_causal_conv_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 11, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    bias = rng.standard_normal((24,)).astype(np.float32)
    want = jax.jit(jm._causal_conv)(x, w, bias)
    _close(mamba2._causal_conv(*map(torch.from_numpy, (x, w, bias))), want,
           1e-6)


@pytest.mark.parametrize("true_len", [None, (7, 2, 0)])
def test_tail_window_and_valid_mask_match_jax(true_len):
    x = np.random.default_rng(5).standard_normal((3, 7, 5)).astype(
        np.float32)
    tl = None if true_len is None else np.array(true_len, np.int32)
    tj = None if tl is None else jnp.asarray(tl)
    tt = None if tl is None else torch.from_numpy(tl)
    got = C.tail_window(torch.from_numpy(x), tt, 3)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(JC.tail_window(x, tj, 3)))
    mask = C.valid_mask(tt, 3, 7)
    want = JC.valid_mask(tj, 3, 7)
    assert (mask is None) == (want is None)
    if mask is not None:
        np.testing.assert_array_equal(mask.numpy(), np.asarray(want))


def test_prefill_and_decode_match_jax():
    """Right-padded prompts of 24 and 13 tokens (three SSD chunks), then
    four greedy decode steps: logits, every cache leaf and the tokens."""
    cj, ct, pj, pt = _setup()
    sj, st = japi.make_spec(cj), api.make_spec(ct, device="cpu")
    pjp, ptp = japi.prepare_params(pj, cj, sj), api.prepare_params(pt, ct,
                                                                   st)
    toks = np.random.default_rng(0).integers(0, ct.vocab, (2, 24)).astype(
        np.int32)
    true_len = np.array([24, 13], np.int32)
    pre = jax.jit(lambda p, t, n: japi.prefill(p, t, cj, sj, max_len=32,
                                               true_len=n))
    dec = jax.jit(lambda p, c, t: japi.decode_step(p, c, t, cj, sj))
    lj, cache_j = pre(pjp, jnp.asarray(toks), jnp.asarray(true_len))
    lt, cache_t = api.prefill(ptp, torch.from_numpy(toks).long(), ct, st,
                              max_len=32, true_len=torch.from_numpy(true_len))
    for step in range(5):
        if step:
            lj, cache_j = dec(pjp, cache_j, jnp.asarray(tj[:, None]))
            lt, cache_t = api.decode_step(ptp, cache_t,
                                          torch.from_numpy(tt[:, None]),
                                          ct, st)
            lj, lt = lj[:, -1], lt[:, -1]
        _close(lt, lj)
        assert set(cache_t) == set(cache_j) == {"conv", "ssm", "length"}
        for key in ("conv", "ssm"):
            assert cache_t[key].shape == cache_j[key].shape
            _close(cache_t[key], cache_j[key])
        tj = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)
        tt = lt.argmax(-1).numpy()
        np.testing.assert_array_equal(tt, tj)
    np.testing.assert_array_equal(cache_t["length"].numpy(), true_len + 4)


def test_decode_returns_fresh_state():
    """decode_step leaves the cache it was given as it was: the paged
    engine's draft and verify snapshots rely on it."""
    _, ct, _, pt = _setup()
    spec = api.make_spec(ct, device="cpu")
    _, cache = api.prefill(pt, torch.ones((2, 8), dtype=torch.long), ct,
                           spec, max_len=16)
    before = {k: v.clone() for k, v in cache.items()}
    _, new = api.decode_step(pt, cache, torch.ones((2, 1), dtype=torch.long),
                             ct, spec)
    for key in before:
        assert torch.equal(cache[key], before[key]), key
        assert new[key].data_ptr() != cache[key].data_ptr(), key


def test_from_reference_keeps_the_reference_dtypes_in_bf16():
    E.reference_dtypes_kept("mamba2-370m", ("A_log", "D", "dt_bias"))


def test_slot_engine_equals_lone_decoding():
    _, ct, _, pt = _setup()
    E.slot_engine_equals_lone_decoding(ct, pt)


@pytest.mark.parametrize("case", sorted(E.PAGED_CASES))
def test_paged_engine_token_identical_to_slot_engine(case):
    _, ct, _, pt = _setup()
    E.paged_equals_slot_engine(ct, pt, case)


def test_draft_and_verify_keep_dense_state():
    _, ct, _, pt = _setup()
    E.draft_and_verify_keep_dense_state(ct, pt)
