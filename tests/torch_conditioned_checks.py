"""Model and engine checks shared by tests/test_torch_encdec.py (reduced
whisper-medium) and tests/test_torch_vision.py (reduced
llama-3.2-vision-11b): families whose requests carry conditioning, frames
or image embeddings, in `extras`.

Params come from `repro.models.api.init_params` through
`weights.from_reference`, with every cross-attention gate `xgate` set to
1.0 first: it starts at 0, and tanh(0) = 0 would multiply the whole image
path away.  Inputs (tokens, frames, images) come from numpy seeds.  The
JAX side runs jitted outside `ctx.use_rules`, under `kernel_policy=
"pallas"` (its kernels in interpret mode) with flash attention; the port
runs on the CPU (each kernel's plain version).  Tolerance as
tests/test_torch_model.py states it: rtol = atol = 1e-5 on logits and
cache leaves, greedy tokens identical.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import torch

import torch_engine_checks as E
from repro import configs as jconfigs
from repro.models import api as japi
from repro_torch import configs
from repro_torch.models import api, weights
from repro_torch.serving import PagedEngine, Request, SamplingParams

TOL = 1e-5
MAX_LEN = 24


def _over(mult: str) -> dict:
    return dict(mult=mult, kernel_policy="pallas", attn_impl="flash")


@functools.lru_cache(maxsize=None)
def setup(arch: str, mult: str):
    """(JAX config, port config, JAX params prepared, port params
    prepared, JAX spec, port spec, raw port params, jitted JAX prefill /
    decode_step / chunk_step)."""
    cj = jconfigs.reduced(jconfigs.get_config(arch), **_over(mult))
    ct = configs.reduced(configs.get_config(arch), **_over(mult))
    pj = japi.init_params(cj, jax.random.key(0))
    if ct.cross_every:
        pj["cross"]["xgate"] = jnp.ones_like(pj["cross"]["xgate"])
    pt = weights.from_reference(jax.tree_util.tree_map(np.asarray, pj), ct,
                                "cpu")
    sj, st = japi.make_spec(cj), api.make_spec(ct, device="cpu")
    pre = jax.jit(lambda p, t, n, e: japi.prefill(
        p, t, cj, sj, max_len=MAX_LEN, extras=e, true_len=n))
    dec = jax.jit(lambda p, c, t, e: japi.decode_step(p, c, t, cj, sj,
                                                      extras=e))
    chunk = jax.jit(lambda p, c, t, e, n: japi.chunk_step(
        p, c, t, cj, sj, extras=e, n_valid=n))
    return (cj, ct, japi.prepare_params(pj, cj, sj),
            api.prepare_params(pt, ct, st), sj, st, pt, pre, dec, chunk)


def conditioning(cfg, b: int, seed: int) -> dict:
    """A batch of seeded extras (`torch_engine_checks.conditioning`)."""
    return E.conditioning(cfg, seed, batch=b)


def _jx(ex: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in ex.items()}


def _tx(ex: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in ex.items()}


def close(got: torch.Tensor, want, tol: float = TOL) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


def caches_close(cache_t: dict, cache_j: dict) -> None:
    assert set(cache_t) == set(cache_j)
    for key in cache_j:
        assert cache_t[key].shape == cache_j[key].shape, key
        close(cache_t[key], cache_j[key])


def prefill_and_decode_match(arch: str, mult: str, s: int,
                             seed: int = 0) -> None:
    """Two right-padded prompts (s and s - 4 valid tokens, drawn from
    `seed`), each with its own conditioning: prefill's logits and every
    cache leaf, then three greedy decode steps' logits and tokens."""
    cj, ct, pjp, ptp, _, st, _, pre, dec, _ = setup(arch, mult)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, ct.vocab, (2, s)).astype(np.int32)
    true_len = np.array([s, s - 4], np.int32)
    ex = conditioning(ct, 2, seed=1)
    lj, cache_j = pre(pjp, jnp.asarray(toks), jnp.asarray(true_len), _jx(ex))
    lt, cache_t = api.prefill(ptp, torch.from_numpy(toks).long(), ct, st,
                              max_len=MAX_LEN, extras=_tx(ex),
                              true_len=torch.from_numpy(true_len))
    close(lt, lj)
    caches_close(cache_t, cache_j)
    tj = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)
    tt = lt.argmax(-1).numpy()
    np.testing.assert_array_equal(tt, tj)
    for _ in range(3):
        lj, cache_j = dec(pjp, cache_j, jnp.asarray(tj[:, None]), _jx(ex))
        lt, cache_t = api.decode_step(ptp, cache_t,
                                      torch.from_numpy(tt[:, None]).long(),
                                      ct, st, _tx(ex))
        close(lt, lj)
        tj = np.asarray(jnp.argmax(lj[:, -1], -1)).astype(np.int32)
        tt = lt[:, -1].argmax(-1).numpy()
        np.testing.assert_array_equal(tt, tj)
    caches_close(cache_t, cache_j)
    np.testing.assert_array_equal(cache_t["length"].numpy(), true_len + 3)


def chunk_step_matches(arch: str, mult: str) -> None:
    """A 6-token prefill, then chunk_step over 6 more tokens of which the
    last 2 are masked, with the request's extras: every position's logits
    and the cache."""
    cj, ct, pjp, ptp, _, st, _, pre, _, chunk = setup(arch, mult)
    rng = np.random.default_rng(9)
    toks = rng.integers(0, ct.vocab, (1, 6)).astype(np.int32)
    nxt = rng.integers(0, ct.vocab, (1, 6)).astype(np.int32)
    ex = conditioning(ct, 1, seed=2)
    _, cache_j = pre(pjp, jnp.asarray(toks), jnp.asarray([6], jnp.int32),
                     _jx(ex))
    _, cache_t = api.prefill(ptp, torch.from_numpy(toks).long(), ct, st,
                             max_len=MAX_LEN, extras=_tx(ex),
                             true_len=torch.tensor([6]))
    lj, cache_j = chunk(pjp, cache_j, jnp.asarray(nxt), _jx(ex),
                        jnp.asarray([4], jnp.int32))
    lt, cache_t = api.chunk_step(ptp, cache_t, torch.from_numpy(nxt).long(),
                                 ct, st, extras=_tx(ex), n_valid=4)
    close(lt, lj)
    caches_close(cache_t, cache_j)
    assert cache_t["length"].tolist() == [10]


def conditioning_moves_logits(arch: str, key: str) -> float:
    """The largest logit change, through prefill and one decode step, when
    `key`'s conditioning is redrawn and every other input kept."""
    _, ct, _, ptp, _, st, _, _, _, _ = setup(arch, "trunc2x2")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, ct.vocab, (2, 12)))
    a, b = conditioning(ct, 2, seed=4), conditioning(ct, 2, seed=4)
    b[key] = conditioning(ct, 2, seed=5)[key]
    gaps = []
    for ex in (a, b):
        lg, cache = api.prefill(ptp, toks, ct, st, max_len=MAX_LEN,
                                extras=_tx(ex))
        step, _ = api.decode_step(ptp, cache, lg.argmax(-1)[:, None], ct,
                                  st, _tx(ex))
        gaps.append((lg, step[:, -1]))
    return max((x - y).abs().max().item()
               for x, y in zip(gaps[0], gaps[1]))


def prefix_pages_follow_conditioning(arch: str,
                                     dtype: str = "float32") -> None:
    """Two requests of equal tokens (two full pages of 8) share their
    prefix pages under equal conditioning and none under other
    conditioning: the prefix key joins the extras' digest.  In bf16 the
    model is the port's own init and the extras are bf16 tensors (numpy
    has no bfloat16: the digest hashes the tensor's raw bytes)."""
    if dtype == "float32":
        _, ct, _, _, _, _, pt, _, _, _ = setup(arch, "trunc2x2")
    else:
        ct = configs.reduced(configs.get_config(arch), dtype=dtype,
                             **_over("trunc2x2"))
        pt = api.init_params(ct, 0, "cpu")
    prompt = np.random.default_rng(6).integers(1, ct.vocab, 20).tolist()
    mine, other = (
        {k: torch.from_numpy(v[0]).to(getattr(torch, dtype))
         for k, v in conditioning(ct, 1, seed).items()} for seed in (7, 8))
    for second, hits in ((mine, 1), (other, 0)):
        eng = PagedEngine(ct, pt, capacity=2, max_len=32, page_size=8,
                          device="cpu")
        for i, ex in enumerate((mine, second)):
            eng.submit(Request(f"r{i}", prompt,
                               SamplingParams(max_new_tokens=2),
                               arrival=float(i), extras=ex))
        done = {c.request_id: c.tokens for c in eng.run_until_complete()}
        st = eng.stats()["paged"]
        assert st["prefix_hits"] == hits, (hits, st)
        assert st["prefix_hit_tokens"] == 16 * hits, st
        eng._alloc.audit()
        assert eng._alloc.pages_live == 0
        assert not eng._digests
        if hits:   # a shared prefix never changes what a request computes
            assert done["r0"] == done["r1"]


def chunked_prefill_equals_whole(arch: str) -> None:
    """Under exact products the chunked prefill (8 tokens, then
    chunk_step over the rest, with the request's extras) gives the whole
    prefill's last logits to 1e-5 for prompts of 9-23 tokens: the paged
    engine's chunked admission computes the same function, and only int8
    codes that flip under an approximate multiplier can part the two."""
    _, ct, _, ptp, _, _, _, _, _, _ = setup(arch, "exact")
    rng = np.random.default_rng(11)
    for n in (9, 16, 23):
        toks = torch.from_numpy(rng.integers(0, ct.vocab, (1, n)))
        ex = _tx(conditioning(ct, 1, seed=n))
        whole, _ = api.prefill(ptp, toks, ct, None, max_len=MAX_LEN,
                               extras=ex)
        _, cache = api.prefill(ptp, toks[:, :8], ct, None, max_len=MAX_LEN,
                               extras=ex)
        chunked, cache = api.chunk_step(ptp, cache, toks[:, 8:], ct, None,
                                        extras=ex)
        close(chunked[:, -1], whole.numpy())
        assert int(cache["length"]) == n
