"""The `hybrid` family (RecurrentGemma: RG-LRU blocks and local sliding-
window attention) of repro_torch against the JAX package's, on the CPU at
the reduced recurrentgemma-9b with 4 layers (one superblock of two
recurrent blocks and an attention block, plus one tail recurrent block:
the reduced config's 2 layers have no attention block at all).

The model checks cut the window to 8, so a 24-token prompt overflows it
and decode wraps the ring.  The engine checks keep the reduced window
(32) above every prompt: past the window, the reference's whole-prompt
prefill and its chunked prefill compute different functions (its
prefill attention sees window + 1 keys, its decode ring window keys;
pinned below), so a slot engine and a chunked paged engine agree only
below it.

Params come from `repro.models.api.init_params` through
`weights.from_reference`; inputs from numpy; the JAX side runs jitted,
under trunc2x2 with `kernel_policy="pallas"`.  Tolerances as
tests/test_torch_ssm.py states them: rtol = atol = 1e-5 for logits and
cache leaves, equal greedy tokens; 2e-6 for the windowed attention
(tests/test_kernels.py's attention tolerance).
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
from repro.models import attention as jatt
from repro.models import rglru as jr
from repro_torch import configs
from repro_torch.models import api, attention, common as C, rglru, weights

TOL = 1e-5
OVER = dict(mult="trunc2x2", kernel_policy="pallas", n_layers=4)

torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _setup(window: int = 0):
    over = dict(OVER, window=window) if window else OVER
    cj = jconfigs.reduced(jconfigs.get_config("recurrentgemma-9b"), **over)
    ct = configs.reduced(configs.get_config("recurrentgemma-9b"), **over)
    pj = japi.init_params(cj, jax.random.key(0))
    pt = weights.from_reference(jax.tree_util.tree_map(np.asarray, pj), ct,
                                "cpu")
    return cj, ct, pj, pt


def _close(got: torch.Tensor, want, tol=TOL) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("s,init", [(24, False), (23, True), (1, True)])
def test_rglru_scan_matches_associative_scan(s, init):
    """The port's doubling scan takes `jax.lax.associative_scan`'s
    recursion, so it matches the reference's to the bit."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, s, 16)).astype(np.float32)
    a = rng.uniform(0.5, 1.0, (2, s, 16)).astype(np.float32)
    h0 = rng.standard_normal((2, 16)).astype(np.float32) if init else None
    hj, lj = jax.jit(jr._rglru_scan)(x, a, h0)
    ht, lt = rglru._rglru_scan(torch.from_numpy(x), torch.from_numpy(a),
                               None if h0 is None else torch.from_numpy(h0))
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))


def test_gelu_matches_jax():
    x = np.random.default_rng(7).standard_normal(4096).astype(np.float32) * 4
    _close(C.gelu(torch.from_numpy(x)), jax.jit(jax.nn.gelu)(x), 1e-6)


@pytest.mark.parametrize("s,window,chunk", [
    (24, 8, 8),       # window < s: each chunk takes a (w + c) slice
    (24, 32, 8),      # window >= s: the causal mask only
    (20, 6, 8),       # a chunk that does not divide s
])
def test_windowed_blockwise_attention_matches_jax(s, window, chunk):
    rng = np.random.default_rng(8)
    q, k, v = (rng.standard_normal((2, s, n, 16)).astype(np.float32)
               for n in (4, 2, 2))
    want = jax.jit(jatt.blockwise_attention, static_argnums=(3, 4, 5))(
        q, k, v, chunk, True, window)
    got = attention.blockwise_attention(
        *map(torch.from_numpy, (q, k, v)), chunk, True, window)
    _close(got, want, 2e-6)
    # the attention dispatch routes a window here whatever the impl
    routed = C.attention(*map(torch.from_numpy, (q, k, v)), impl="flash",
                         chunk=chunk, window=window, policy="pallas")
    assert torch.equal(routed, got)


def _jax_fns(cj, sj):
    pre = jax.jit(lambda p, t, n: japi.prefill(p, t, cj, sj, max_len=32,
                                               true_len=n))
    dec = jax.jit(lambda p, c, t: japi.decode_step(p, c, t, cj, sj))
    return pre, dec


def _caches_close(cache_t: dict, cache_j: dict) -> None:
    assert set(cache_t) == set(cache_j)
    for key in cache_j:
        assert cache_t[key].shape == cache_j[key].shape, key
        _close(cache_t[key], cache_j[key])


def test_prefill_and_decode_match_jax():
    """Right-padded prompts of 24 and 13 tokens against a window of 8
    (the ring holds the last 8 positions, in slot order), then five
    greedy decode steps that wrap it: logits, every cache leaf (rings,
    conv tails, RG-LRU states of the superblock and the tail) and the
    tokens."""
    cj, ct, pj, pt = _setup(window=8)
    sj, st = japi.make_spec(cj), api.make_spec(ct, device="cpu")
    pjp, ptp = japi.prepare_params(pj, cj, sj), api.prepare_params(pt, ct,
                                                                   st)
    pre, dec = _jax_fns(cj, sj)
    toks = np.random.default_rng(0).integers(0, ct.vocab, (2, 24)).astype(
        np.int32)
    true_len = np.array([24, 13], np.int32)
    lj, cache_j = pre(pjp, jnp.asarray(toks), jnp.asarray(true_len))
    lt, cache_t = api.prefill(ptp, torch.from_numpy(toks).long(), ct, st,
                              max_len=32, true_len=torch.from_numpy(true_len))
    assert set(cache_t) == {"rec_conv", "rec_lru", "att_k", "att_v",
                            "tail_conv", "tail_lru", "length"}
    for step in range(6):
        if step:
            lj, cache_j = dec(pjp, cache_j, jnp.asarray(tj[:, None]))
            lt, cache_t = api.decode_step(ptp, cache_t,
                                          torch.from_numpy(tt[:, None]),
                                          ct, st)
            lj, lt = lj[:, -1], lt[:, -1]
        _close(lt, lj)
        _caches_close(cache_t, cache_j)
        tj = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)
        tt = lt.argmax(-1).numpy()
        np.testing.assert_array_equal(tt, tj)
    np.testing.assert_array_equal(cache_t["length"].numpy(), true_len + 5)


def test_chunk_step_matches_jax_with_a_masked_tail():
    """chunk_step over 6 tokens of which the last 2 are masked: every
    position's logits (the masked ones from the state after the valid
    steps) and the cache, which the masked steps leave as it was."""
    cj, ct, pj, pt = _setup(window=8)
    sj, st = japi.make_spec(cj), api.make_spec(ct, device="cpu")
    pjp, ptp = japi.prepare_params(pj, cj, sj), api.prepare_params(pt, ct,
                                                                   st)
    pre, _ = _jax_fns(cj, sj)
    rng = np.random.default_rng(9)
    toks = rng.integers(0, ct.vocab, (1, 6)).astype(np.int32)
    nxt = rng.integers(0, ct.vocab, (1, 6)).astype(np.int32)
    _, cache_j = pre(pjp, jnp.asarray(toks), jnp.asarray([6], jnp.int32))
    _, cache_t = api.prefill(ptp, torch.from_numpy(toks).long(), ct, st,
                             max_len=32, true_len=torch.tensor([6]))
    lj, cache_j = jax.jit(lambda p, c, t: japi.chunk_step(
        p, c, t, cj, sj, n_valid=jnp.asarray([4], jnp.int32)))(
        pjp, cache_j, jnp.asarray(nxt))
    lt, cache_t = api.chunk_step(ptp, cache_t, torch.from_numpy(nxt).long(),
                                 ct, st, n_valid=4)
    _close(lt, lj)
    _caches_close(cache_t, cache_j)
    assert cache_t["length"].tolist() == [10]


def test_chunked_prefill_past_the_window_differs_in_the_reference():
    """Reference behaviour the port keeps: prefill attention lets a query
    see the keys at i - window ... i (window + 1 of them, the mask
    `(qi - ki) <= window`), while decode's ring holds `window`.  So a
    prompt longer than the window gives other logits through prefill of
    its first 8 tokens plus chunk_step than through one prefill, in the
    JAX package and in the port alike, each equal to the other's."""
    cj, ct, pj, pt = _setup(window=8)
    sj, st = japi.make_spec(cj), api.make_spec(ct, device="cpu")
    pjp, ptp = japi.prepare_params(pj, cj, sj), api.prepare_params(pt, ct,
                                                                   st)
    toks = np.random.default_rng(10).integers(0, ct.vocab, (1, 14)).astype(
        np.int32)
    whole_j, _ = jax.jit(lambda p, t: japi.prefill(p, t, cj, sj))(
        pjp, jnp.asarray(toks))
    _, c8 = jax.jit(lambda p, t: japi.prefill(p, t, cj, sj, max_len=16))(
        pjp, jnp.asarray(toks[:, :8]))
    lj, _ = jax.jit(lambda p, c, t: japi.chunk_step(p, c, t, cj, sj))(
        pjp, c8, jnp.asarray(toks[:, 8:]))
    whole_t, _ = api.prefill(ptp, torch.from_numpy(toks).long(), ct, st)
    _, c8t = api.prefill(ptp, torch.from_numpy(toks[:, :8]).long(), ct, st,
                         max_len=16)
    lt, _ = api.chunk_step(ptp, c8t, torch.from_numpy(toks[:, 8:]).long(),
                           ct, st)
    _close(whole_t, whole_j)
    _close(lt[:, -1], lj[:, -1])
    gap = np.abs(np.asarray(whole_j) - np.asarray(lj[:, -1])).max()
    assert gap > 1e-2, gap


def test_from_reference_keeps_the_reference_dtypes_in_bf16():
    E.reference_dtypes_kept("recurrentgemma-9b", ("lam",))


def test_slot_engine_equals_lone_decoding():
    _, ct, _, pt = _setup()
    E.slot_engine_equals_lone_decoding(ct, pt)


@pytest.mark.parametrize("case", sorted(E.PAGED_CASES))
def test_paged_engine_token_identical_to_slot_engine(case):
    _, ct, _, pt = _setup()
    E.paged_equals_slot_engine(ct, pt, case)


@pytest.mark.parametrize("window", [0, 8])
def test_draft_and_verify_keep_dense_state(window):
    """At window 8 the prompts (7-12 tokens) and the steps wrap the rings,
    which decode writes in place."""
    _, ct, _, pt = _setup(window=window)
    E.draft_and_verify_keep_dense_state(ct, pt)


def test_rings_do_not_page():
    """The rings are window-sized, not max_len-sized: every leaf stays a
    dense per-slot leaf of the paged arena, at the slot arena's shapes."""
    _, ct, _, pt = _setup()
    from repro_torch.serving.arena import PagedArena, SlotArena
    paged = PagedArena(ct, 3, 64, 8, 25, torch.device("cpu"))
    slot = SlotArena(ct, 3, 64, torch.device("cpu"))
    assert paged.paged == {}
    assert {k: v.shape for k, v in paged.cache.items()} == \
        {k: v.shape for k, v in slot.cache.items()}
    assert paged.slot_axes == slot.slot_axes == {
        "rec_conv": 2, "rec_lru": 2, "att_k": 1, "att_v": 1,
        "tail_conv": 1, "tail_lru": 1, "length": 0}
    one = SlotArena(ct, 1, 64, torch.device("cpu"))
    assert one.slot_axes == slot.slot_axes


def test_long_prompt_gap_is_one_int8_rounding_tie(monkeypatch):
    """A 128-token prompt (the paged trace's second one) where the port and
    the JAX package part by ~0.05 in the logits, with the witness of why:
    every activation quantizer of its prefill is recorded in both
    packages.  All int8 codes agree until the attention block's q/k/v
    input (GEMM 12, after the two recurrent blocks' six each), and there
    exactly one code differs, at position 59: its x / scale lies on
    opposite sides of the 47.5 rounding boundary in the two packages
    while the two f32 values agree to a few ulps.  A port fault would
    move codes away from such ties."""
    from repro.approx import gemm as JG
    from repro_torch.approx import gemm as TG

    cj, ct, pj, pt = _setup()
    rng = np.random.default_rng(0)
    rng.integers(0, ct.vocab, 40)
    toks = rng.integers(0, ct.vocab, 128).tolist()
    jrec, trec = [], []
    jquant, tquant = JG._quantize_activations, TG._quantize_activations

    def jrecord(x2, spec, use_pallas, mesh=None):
        q, s = jquant(x2, spec, use_pallas, mesh)
        jax.debug.callback(
            lambda *a: jrec.append([np.asarray(v) for v in a]), x2, q, s,
            ordered=True)
        return q, s

    def trecord(x2, spec, use_kernels):
        q, s = tquant(x2, spec, use_kernels)
        trec.append([t.numpy().copy() for t in (x2, q, s)])
        return q, s

    monkeypatch.setattr(JG, "_quantize_activations", jrecord)
    monkeypatch.setattr(TG, "_quantize_activations", trecord)
    sj = japi.make_spec(cj)
    jax.jit(lambda p, t: japi.prefill(p, t, cj, sj))(
        japi.prepare_params(pj, cj, sj), jnp.asarray([toks], jnp.int32))
    jax.effects_barrier()
    st = api.make_spec(ct, device="cpu")
    api.prefill(api.prepare_params(pt, ct, st), torch.tensor([toks]), ct, st)

    # 3 recurrent blocks x 6, the attention block's 7, the head
    assert len(jrec) == len(trec) == 26
    first = next(i for i, (j, t) in enumerate(zip(jrec, trec))
                 if not np.array_equal(j[1], t[1]))
    assert first == 12
    (xj, qj, sj_), (xt, qt, st_) = jrec[first], trec[first]
    np.testing.assert_allclose(xt, xj, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(st_, sj_, rtol=1e-6)
    (r, c), = np.argwhere(qj != qt).tolist()
    assert r == 59
    vj = np.float64(xj[r, c]) / np.float64(sj_[r, 0])
    vt = np.float64(xt[r, c]) / np.float64(st_[r, 0])
    assert abs(vj - vt) <= 8 * np.spacing(np.float32(vt))
    tie = np.floor(min(vj, vt)) + 0.5
    assert min(vj, vt) < tie < max(vj, vt), (vj, vt)
