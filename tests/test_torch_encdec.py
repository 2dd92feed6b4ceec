"""The `encdec` family (Whisper: LayerNorm, biased projections, GELU MLP,
sinusoidal encoder positions, learned decoder positions, tied head) and
the shared layers it needs, repro_torch against the JAX package's, on the
CPU at the reduced whisper-medium (2 + 2 layers, d 128, 16 frames).

Each request carries seeded random frames: zeros are the reference's
default, and a check on zeros would not see the frames path.  A prompt of
exactly 16 tokens (the reduced `enc_seq`) sends the decoder's
cross-attention through the config's attention impl (the reference's
rule: equal lengths take `cfg.attn_impl`); other lengths take the naive
one.  Setup and tolerances: tests/torch_conditioned_checks.py.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import torch_conditioned_checks as K
import torch_engine_checks as E
from repro.models import common as JC
from repro.models import encdec as jenc
from repro_torch.models import common as C, encdec

ARCH = "whisper-medium"

torch.set_num_threads(1)


def test_layernorm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 7, 64)).astype(np.float32) * 3 + 1
    s, b = (rng.standard_normal((64,)).astype(np.float32) * 0.1
            for _ in range(2))
    K.close(C.layernorm(*map(torch.from_numpy, (x, s, b))),
            JC.layernorm(*map(jnp.asarray, (x, s, b))), 1e-6)


@pytest.mark.parametrize("s,d", [(16, 128), (1500, 1024)])
def test_sinusoid_positions_match_jax(s, d):
    """The reduced encoder's and whisper-medium's own (1500 frames)."""
    K.close(C.sinusoid_positions(s, d), JC.sinusoid_positions(s, d), 1e-6)


def test_gelu_mlp_matches_jax():
    """Biased up and down projections around the tanh GELU, exact."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    wu, wd = (rng.standard_normal(s).astype(np.float32) * 0.1
              for s in ((64, 96), (96, 64)))
    bu, bd = (rng.standard_normal(n).astype(np.float32) for n in (96, 64))
    args = (x, wu, bu, wd, bd)
    K.close(C.gelu_mlp(*map(torch.from_numpy, args), None),
            JC.gelu_mlp(*map(jnp.asarray, args), None), 1e-6)


def test_encode_and_precompute_cross_match_jax():
    cj, ct, pjp, ptp, sj, st, *_ = K.setup(ARCH, "trunc2x2")
    frames = K.conditioning(ct, 2, seed=0)["frames"]
    enc_j = jax.jit(lambda p, f: jenc.encode(p, f, cj, sj))(pjp, frames)
    enc_t = encdec.encode(ptp, torch.from_numpy(frames), ct, st)
    K.close(enc_t, enc_j)
    xk_j, xv_j = jax.jit(lambda p, e: jenc.precompute_cross(p, e, cj, sj))(
        pjp, enc_j)
    xk_t, xv_t = encdec.precompute_cross(ptp, enc_t, ct, st)
    assert xk_t.shape == (ct.n_layers, 2, ct.enc_seq, ct.n_kv_heads, ct.hd)
    K.close(xk_t, xk_j)
    K.close(xv_t, xv_j)


@pytest.mark.parametrize("s", [16, 12], ids=["enc_seq", "other"])
@pytest.mark.parametrize("mult", ["trunc2x2", "exact"])
def test_prefill_and_decode_match_jax(mult, s):
    """Prompts of s and s - 4 valid tokens: s = 16 (enc_seq) takes the
    cross-attention through flash, s = 12 through the naive impl."""
    K.prefill_and_decode_match(ARCH, mult, s)


@pytest.mark.parametrize("mult", ["trunc2x2", "exact"])
def test_chunk_step_matches_jax(mult):
    K.chunk_step_matches(ARCH, mult)


def test_frames_move_the_logits():
    assert K.conditioning_moves_logits(ARCH, "frames") > 1e-2


def test_decode_leaves_cross_kv_untouched():
    """decode_step returns the cross K/V as the same tensors, unchanged:
    what lets the paged engine skip copying them
    (`api.static_cache_keys`)."""
    _, ct, _, ptp, _, st, *_ = K.setup(ARCH, "trunc2x2")
    ex = K.conditioning(ct, 2, seed=0)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, ct.vocab, (2, 9)))
    _, cache = encdec.prefill(ptp, toks, ct, st, max_len=16,
                              frames=torch.from_numpy(ex["frames"]))
    before = {k: cache[k].clone() for k in ("xk", "xv")}
    _, new = encdec.decode_step(ptp, cache, toks[:, :1], ct, st)
    for key in ("xk", "xv"):
        assert new[key] is cache[key] and torch.equal(new[key], before[key])
    from repro_torch.models import api
    assert api.static_cache_keys(ct) == {"xk", "xv"}


def test_chunked_prefill_equals_whole_prefill_under_exact():
    K.chunked_prefill_equals_whole(ARCH)


def test_from_reference_keeps_the_reference_dtypes_in_bf16():
    E.reference_dtypes_kept(ARCH, ())


def test_slot_engine_equals_lone_decoding():
    _, ct, *_, pt, _, _, _ = K.setup(ARCH, "trunc2x2")
    E.slot_engine_equals_lone_decoding(ct, pt)


@pytest.mark.parametrize("case", sorted(E.PAGED_CASES))
def test_paged_engine_token_identical_to_slot_engine(case):
    """The self K/V page; the cross K/V stay dense per-slot leaves."""
    _, ct, *_, pt, _, _, _ = K.setup(ARCH, "trunc2x2")
    E.paged_equals_slot_engine(ct, pt, case, paged_leaves=("k", "v"))


def test_prefix_pages_follow_the_frames():
    K.prefix_pages_follow_conditioning(ARCH)


def test_prefix_pages_follow_bf16_tensor_frames():
    K.prefix_pages_follow_conditioning(ARCH, "bfloat16")


def test_seed12_divergence_is_one_int8_rounding_tie(monkeypatch):
    """Prompts drawn from seed 12 (s = 12, trunc2x2), where the port and
    the JAX package part by ~0.03 on one row's logits at the first decode
    step, with the witness of why: every activation quantizer of that
    step is recorded in both packages.  All int8 codes agree until layer
    1's q projection input (GEMM 8, after layer 0's eight), and there
    exactly one code differs: its x / scale lies on opposite sides of the
    -24.5 rounding boundary in the two packages while the two f32 values
    agree to an ulp.  A port fault would move codes away from such ties
    (the same prompts from seeds 0-3 agree to 1e-5)."""
    from repro.approx import gemm as JG
    from repro.models import api as japi
    from repro_torch.approx import gemm as TG
    from repro_torch.models import api

    cj, ct, pjp, ptp, sj, st, _, pre, _, _ = K.setup(ARCH, "trunc2x2")
    toks = np.random.default_rng(12).integers(0, ct.vocab, (2, 12)).astype(
        np.int32)
    true_len = np.array([12, 8], np.int32)
    ex = K.conditioning(ct, 2, seed=1)
    lj, cache_j = pre(pjp, jnp.asarray(toks), jnp.asarray(true_len),
                      K._jx(ex))
    lt, cache_t = api.prefill(ptp, torch.from_numpy(toks).long(), ct, st,
                              max_len=K.MAX_LEN, extras=K._tx(ex),
                              true_len=torch.from_numpy(true_len))
    K.close(lt, lj)
    tok = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)[:, None]
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
    lj, _ = jax.jit(lambda p, c, t: japi.decode_step(p, c, t, cj, sj))(
        pjp, cache_j, jnp.asarray(tok))
    jax.effects_barrier()
    lt, _ = api.decode_step(ptp, cache_t, torch.from_numpy(tok).long(), ct,
                            st)
    gap = np.abs(lt.numpy() - np.asarray(lj)).max(axis=(1, 2))
    assert gap[0] > 1e-2 and gap[1] < 1e-5, gap

    # 2 layers x 8 GEMMs, the tied head
    assert len(jrec) == len(trec) == 17
    first = next(i for i, (j, t) in enumerate(zip(jrec, trec))
                 if not np.array_equal(j[1], t[1]))
    assert first == 8
    (xj, qj, sj_), (xt, qt, st_) = jrec[first], trec[first]
    np.testing.assert_allclose(xt, xj, rtol=1e-5, atol=1e-6)
    (r, c), = np.argwhere(qj != qt).tolist()
    assert r == 0
    vj = np.float64(xj[r, c]) / np.float64(sj_[r, 0])
    vt = np.float64(xt[r, c]) / np.float64(st_[r, 0])
    assert abs(vj - vt) <= 8 * np.spacing(np.float32(abs(vt)))
    tie = np.floor(min(vj, vt)) + 0.5
    assert min(vj, vt) < tie < max(vj, vt), (vj, vt)
