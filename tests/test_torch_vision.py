"""The vision-cross-attention `lm` (llama-3.2-vision: superblocks of
`cross_every` self-attention layers and one gated cross-attention layer
over image embeddings) and the GELU-MLP dense `lm` (starcoder2-7b's
path, in tests/test_torch_model.py), repro_torch against the JAX
package's, on the CPU at the reduced llama-3.2-vision-11b (4 layers in 2
superblocks of 2, d 128, 16 image tokens).

Every check sets each superblock's `xgate` to 1.0: it starts at 0, and
tanh(0) = 0 multiplies the whole image path away, so a check at init
would not see it.  Each request carries seeded random image embeddings;
the image state is kept per slot and passed to every decode step.  Setup
and tolerances: tests/torch_conditioned_checks.py.
"""

import numpy as np
import pytest
import jax
import torch

import torch_conditioned_checks as K
import torch_engine_checks as E
from repro.models import attention as jatt
from repro.models import transformer as jtr
from repro_torch.models import attention, common as C, transformer

ARCH = "llama-3.2-vision-11b"

torch.set_num_threads(1)


def test_cross_block_matches_jax():
    """One gated cross-attention block at superblock 1, on its own."""
    cj, ct, pjp, ptp, sj, st, *_ = K.setup(ARCH, "trunc2x2")
    rng = np.random.default_rng(0)
    h = rng.standard_normal((2, 5, ct.d_model)).astype(np.float32)
    img = K.conditioning(ct, 2, seed=0)["img_embeds"]
    xp_j = jax.tree_util.tree_map(lambda a: a[1], pjp["cross"])
    want = jax.jit(lambda x, p, i: jtr.cross_block(x, p, i, cj, sj))(
        h, xp_j, img)
    got = transformer.cross_block(
        torch.from_numpy(h), C.block_params(ptp["cross"], 1),
        torch.from_numpy(img), ct, st)
    K.close(got, want)
    assert (got - torch.from_numpy(h)).abs().max() > 1e-2   # the gate is on


@pytest.mark.parametrize("sq,skv,chunk", [(5, 40, 16), (33, 20, 8)])
def test_blockwise_attention_across_lengths_matches_jax(sq, skv, chunk):
    """The non-causal blockwise forward a cross-attention block takes past
    2^20 scores, here at lengths that do not divide the chunk."""
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, sq, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, skv, 2, 16)).astype(np.float32)
            for _ in range(2))
    want = jax.jit(jatt.blockwise_attention, static_argnums=(3, 4, 5))(
        q, k, v, chunk, False, 0)
    got = attention.blockwise_attention(*map(torch.from_numpy, (q, k, v)),
                                        chunk, False, 0)
    K.close(got, want, 2e-6)


@pytest.mark.parametrize("s", [16, 12])
@pytest.mark.parametrize("mult", ["trunc2x2", "exact"])
def test_prefill_and_decode_match_jax(mult, s):
    K.prefill_and_decode_match(ARCH, mult, s)


@pytest.mark.parametrize("mult", ["trunc2x2", "exact"])
def test_chunk_step_matches_jax(mult):
    K.chunk_step_matches(ARCH, mult)


def test_image_moves_the_logits():
    assert K.conditioning_moves_logits(ARCH, "img_embeds") > 1e-2


def test_superblock_layout():
    """layers (n_super, cross_every, ...), cross (n_super, ...), the cache
    (n_super, cross_every, b, max_len, kv, hd): the self K/V page along
    max_len; prepared weights slice per matrix through both stack axes."""
    _, ct, _, ptp, *_ = K.setup(ARCH, "trunc2x2")
    assert ptp["layers"]["wq"].wq.shape == (2, 2, 128, 128)
    assert ptp["cross"]["xwk"].wq.shape == (2, 128, 64)
    assert ptp["cross"]["xgate"].shape == (2, 1)
    pw = C.block_params(ptp["layers"], 1, 0)["wq"]
    assert pw.wq.shape == (128, 128)
    assert torch.equal(pw.wq, ptp["layers"]["wq"].wq[1, 0])
    from repro_torch.serving.arena import PagedArena
    arena = PagedArena(ct, 3, 32, 8, 13, torch.device("cpu"))
    assert arena.paged == {"k": 2, "v": 2}
    assert arena.cache["k"].shape == (2, 2, 13 * 8, 2, 32)


def test_chunked_prefill_equals_whole_prefill_under_exact():
    K.chunked_prefill_equals_whole(ARCH)


def test_from_reference_keeps_the_reference_dtypes_in_bf16():
    E.reference_dtypes_kept(ARCH, ())


def test_slot_engine_equals_lone_decoding():
    _, ct, *_, pt, _, _, _ = K.setup(ARCH, "trunc2x2")
    E.slot_engine_equals_lone_decoding(ct, pt)


@pytest.mark.parametrize("case", sorted(E.PAGED_CASES))
def test_paged_engine_token_identical_to_slot_engine(case):
    _, ct, *_, pt, _, _, _ = K.setup(ARCH, "trunc2x2")
    E.paged_equals_slot_engine(ct, pt, case, paged_leaves=("k", "v"))


def test_prefix_pages_follow_the_image():
    K.prefix_pages_follow_conditioning(ARCH)


def test_prefix_pages_follow_bf16_tensor_image():
    K.prefix_pages_follow_conditioning(ARCH, "bfloat16")


def test_engine_keeps_each_slots_image():
    """The slot engine writes each admitted request's image into its
    slot (in the model's dtype) and refuses one that does not reshape to
    (n_img_tokens, d_model), or a key the model does not take."""
    from repro_torch.serving import Engine, Request, SamplingParams
    _, ct, *_, pt, _, _, _ = K.setup(ARCH, "trunc2x2")
    eng = Engine(ct, pt, capacity=2, max_len=16, device="cpu")
    imgs = [K.conditioning(ct, 1, seed=i)["img_embeds"][0] for i in (3, 4)]
    for i, img in enumerate(imgs):
        eng.submit(Request(f"r{i}", [1, 2, 3],
                           SamplingParams(max_new_tokens=4),
                           extras={"img_embeds": img}))
    eng.step()
    for i, img in enumerate(imgs):
        slot = next(j for j, s in enumerate(eng._slots)
                    if s is not None and s.request.request_id == f"r{i}")
        assert torch.equal(eng._img[slot], torch.from_numpy(img))
    with pytest.raises(ValueError, match="reshape"):
        eng.submit(Request("bad", [1], extras={"img_embeds": np.zeros(5)}))
    with pytest.raises(ValueError, match="frames"):
        eng.submit(Request("key", [1], extras={"frames": imgs[0]}))
