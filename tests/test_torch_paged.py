"""repro_torch's paged serving stack on the CPU, at the reduced TinyLlama
(2 layers, d 128).

The oracle is split as the reference's own suite allows here:

  * `PageAllocator`, `PagedArena` and `api.chunk_step` are held against the
    JAX package's, function for function, on the same inputs bridged
    through numpy: the allocators in lockstep (every lease, table,
    `stats()` and `audit()` equal at every step), the arenas bit for bit,
    `chunk_step` within rtol=atol=1e-5 (the tolerance of
    tests/test_torch_model.py) with equal greedy ids;
  * `PagedEngine` (paged, chunked, speculative with an exact and a
    trunc4x4 draft, all stacked) is held token for token against the
    port's own slot `Engine`, which tests/test_torch_serving.py holds to
    the JAX package's greedy loop — the contract tests/test_serving_paged.py
    states for the reference engines, which cannot run on the installed
    JAX.  One greedy trace also goes end to end against the JAX greedy
    loop.
"""

import functools
import random

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from hypothesis import settings, strategies as st
from hypothesis.stateful import (
    RuleBasedStateMachine, invariant, precondition, rule,
)

from repro import configs as jconfigs
from repro.models import api as japi
from repro.serving import arena as jarena
from repro.serving import paging as jpaging
from repro_torch import configs
from repro_torch.models import api, weights
from repro_torch.serving import (
    Engine, PagedEngine, Request, SamplingParams, paging,
)
from repro_torch.serving.arena import PagedArena
from repro_torch.serving.scheduler import Scheduler

OVER = dict(mult="trunc2x2", kernel_policy="pallas", attn_impl="flash")
TOL = 1e-5

torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _setup(mult="trunc2x2"):
    over = dict(OVER, mult=mult)
    cj = jconfigs.reduced(jconfigs.get_config("tinyllama-1.1b"), **over)
    ct = configs.reduced(configs.get_config("tinyllama-1.1b"), **over)
    pj = japi.init_params(cj, jax.random.key(0))
    pt = weights.from_reference(jax.tree_util.tree_map(np.asarray, pj), ct,
                                "cpu")
    return cj, ct, pj, pt


def _prompt(n, seed, vocab=512):
    return np.random.default_rng(seed).integers(1, vocab, (n,)).tolist()


def _mixed_trace(n_requests=8, seed=1):
    """tests/test_serving_paged.py's mixed-arrival trace: heterogeneous
    prompt lengths, staggered arrivals, alternating greedy and seeded
    sampled rows."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_requests):
        n = int(rng.integers(4, 24))
        gen = int(rng.integers(2, 6))
        sp = SamplingParams(max_new_tokens=gen) if i % 2 == 0 else \
            SamplingParams(temperature=0.9, top_k=8, max_new_tokens=gen,
                           seed=100 + i)
        out.append(Request(f"t{i}", rng.integers(1, 512, (n,)).tolist(), sp,
                           arrival=float(i) * 0.7))
    return out


def _serve(engine, trace):
    for req in trace:
        engine.submit(req)
    return {c.request_id: (c.tokens, c.finish_reason)
            for c in engine.run_until_complete()}


def _engine(cls, mult="trunc2x2", **kw):
    _, ct, _, pt = _setup(mult)
    kw.setdefault("seed", 0)
    return cls(ct, pt, device="cpu", **kw)


def _differential(trace, capacity=3, max_len=64, mult="trunc2x2", **paged):
    base = _serve(_engine(Engine, mult, capacity=capacity, max_len=max_len),
                  list(trace))
    eng = _engine(PagedEngine, mult, capacity=capacity, max_len=max_len,
                  **paged)
    got = _serve(eng, list(trace))
    assert got == base, (paged, base, got)
    eng._alloc.audit()
    assert eng._alloc.pages_live == 0
    return eng


# --- the allocator against the JAX package's, in lockstep -----------------

class _Lockstep:
    """Both allocators driven by the same calls; results, raised errors,
    every table, `stats()` and `audit()` compared after each call."""

    def __init__(self, n_pages, page_size):
        self.ref = jpaging.PageAllocator(n_pages, page_size)
        self.port = paging.PageAllocator(n_pages, page_size)

    def __call__(self, op, *args, **kw):
        out = []
        for a, err in ((self.ref, jpaging.PagingError),
                       (self.port, paging.PagingError)):
            try:
                r = getattr(a, op)(*args, **kw)
            except err as e:
                r = ("PagingError", str(e))
            if r is not None and hasattr(r, "pages"):
                r = (r.pages, r.shared_pages, r.hit_tokens)
            out.append(r)
        assert out[0] == out[1], (op, args, out)
        self.check()
        return out[1]

    def check(self):
        ref, port = self.ref, self.port
        assert ref.stats() == port.stats()
        assert ref.holders() == port.holders()
        for rid in ref.holders():
            assert ref.table(rid) == port.table(rid)
            for i in range(len(ref.table(rid))):
                assert ref.writable(rid, i) == port.writable(rid, i)
        assert (ref.pages_free, ref.pages_live) == \
            (port.pages_free, port.pages_live)
        ref.audit()
        port.audit()


class AllocatorLockstepMachine(RuleBasedStateMachine):
    """tests/test_property.py's allocator state machine, driving the JAX
    package's allocator and the port's through the same calls."""

    def __init__(self):
        super().__init__()
        self.both = _Lockstep(n_pages=9, page_size=4)
        self.live: set[str] = set()
        self.counter = 0

    @rule(n=st.integers(1, 30), share=st.booleans(),
          prefix_word=st.integers(1, 3))
    def allocate(self, n, share, prefix_word):
        rid = f"r{self.counter}"
        self.counter += 1
        prompt = tuple([prefix_word] * n) if share else None
        lease = self.both("alloc", rid, n, prompt=prompt, digest="d")
        if lease is None:
            return
        self.live.add(rid)
        if prompt is not None:
            self.both("register_prefix", rid, prompt, "d")

    @precondition(lambda self: self.live)
    @rule(data=st.data())
    def free(self, data):
        rid = data.draw(st.sampled_from(sorted(self.live)))
        self.both("free", rid)
        self.live.discard(rid)
        assert self.both("free", rid)[0] == "PagingError"   # double free

    @precondition(lambda self: self.live)
    @rule(data=st.data())
    def fork(self, data):
        src = data.draw(st.sampled_from(sorted(self.live)))
        dst = f"f{self.counter}"
        self.counter += 1
        self.both("fork", src, dst)
        self.live.add(dst)

    @precondition(lambda self: self.live)
    @rule(data=st.data(), idx=st.integers(0, 29))
    def cow(self, data, idx):
        rid = data.draw(st.sampled_from(sorted(self.live)))
        i = idx % len(self.both.port.table(rid))
        self.both("cow", rid, i)

    @invariant()
    def trash_page_never_leased(self):
        for rid in self.live:
            assert paging.TRASH_PAGE not in self.both.port.table(rid)


TestAllocatorLockstep = AllocatorLockstepMachine.TestCase
TestAllocatorLockstep.settings = settings(
    max_examples=40, stateful_step_count=60, deadline=None)


@pytest.mark.parametrize("seed", [23, 7])
def test_allocator_random_walk_lockstep(seed):
    """tests/test_serving_paged.py's seeded alloc/free/fork/COW walk, on
    both allocators at once."""
    rng = random.Random(seed)
    both = _Lockstep(n_pages=9, page_size=4)
    live: list[str] = []
    for step in range(400):
        op = rng.randrange(5)
        if op in (0, 1):
            rid = f"r{step}"
            n = rng.randrange(1, 30)
            prompt = tuple([rng.randrange(1, 3)] * n) \
                if rng.random() < 0.5 else None
            if both("alloc", rid, n, prompt=prompt, digest="d") is not None:
                live.append(rid)
                if prompt is not None:
                    both("register_prefix", rid, prompt, "d")
        elif op == 2 and live:
            both("free", live.pop(rng.randrange(len(live))))
        elif op == 3 and live:
            dst = f"f{step}"
            both("fork", rng.choice(live), dst)
            live.append(dst)
        elif op == 4 and live:
            rid = rng.choice(live)
            both("cow", rid, rng.randrange(len(both.port.table(rid))))
    assert both("free", "never-allocated")[0] == "PagingError"
    for rid in live:
        both("free", rid)
    assert both.port.pages_live == 0


def test_alloc_reclaim_never_evicts_pending_shared_pages():
    """The reference's regression: under pool pressure `alloc` pins its
    prefix-hit pages before reclaiming."""
    both = _Lockstep(n_pages=7, page_size=2)
    pa, px = (1, 1, 1, 1), (9, 9)
    assert both("alloc", "A", 4, prompt=pa, digest="d") is not None
    both("register_prefix", "A", pa, "d")
    both("free", "A")
    assert both("alloc", "X", 2, prompt=px, digest="d") is not None
    both("register_prefix", "X", px, "d")
    both("free", "X")
    assert both("alloc", "B", 6) is not None
    pages, shared, _ = both("alloc", "C", 6, prompt=pa, digest="d")
    assert shared == 2 and len(set(pages)) == len(pages) == 3
    assert both.port.reclaimed_pages == 1


def test_alloc_failure_with_shared_pages_rolls_back_pins():
    both = _Lockstep(n_pages=5, page_size=2)
    pa = (1, 1, 1, 1)
    assert both("alloc", "A", 4, prompt=pa, digest="d") is not None
    both("register_prefix", "A", pa, "d")
    both("free", "A")
    assert both("alloc", "B", 4) is not None
    assert both("alloc", "C", 8, prompt=pa, digest="d") is None
    assert both.port.alloc_failures == 1
    both("free", "B")
    assert both("alloc", "D", 4, prompt=pa, digest="d")[1] == 2


# --- PagedArena against the JAX package's ---------------------------------

def _arenas(capacity=3, max_len=32, page_size=8, n_pages=10):
    cj, ct, _, _ = _setup()
    ja = jarena.PagedArena(cj, capacity, max_len, page_size, n_pages)
    ta = PagedArena(ct, capacity, max_len, page_size, n_pages,
                    torch.device("cpu"))
    return ja, ta


def _same_pools(tcache, jcache, keys=("k", "v"), skip_trash=True):
    for key in keys:
        t, j = tcache[key].numpy(), np.asarray(jcache[key])
        if skip_trash:   # several lanes may land on the trash row
            t, j = t[:, 1:], j[:, 1:]
        np.testing.assert_array_equal(t, j, err_msg=key)


def test_paged_arena_matches_jax_bitwise():
    ja, ta = _arenas()
    assert ta.paged == ja.paged == {"k": 1, "v": 1}
    assert ta.slot_axes == ja.slot_axes
    assert ta.max_pages == ja.max_pages == 4
    assert {k: tuple(v.shape) for k, v in ta.cache.items()} == \
        {k: tuple(v.shape) for k, v in ja.cache.items()}
    rng = np.random.default_rng(5)
    pools = {k: rng.standard_normal(ta.cache[k].shape).astype(np.float32)
             for k in ("k", "v")}
    lengths = np.array([5, 17, 0], np.int32)
    table = np.array([[3, 7, 0, 0], [1, 2, 9, 4], [0, 0, 0, 0]], np.int32)
    jcache = {**{k: jnp.asarray(v) for k, v in pools.items()},
              "length": jnp.asarray(lengths)}
    tcache = {**{k: torch.from_numpy(v.copy()) for k, v in pools.items()},
              "length": torch.from_numpy(lengths)}
    jview = ja.view(jcache, jnp.asarray(table))
    tview = ta.view(tcache, torch.from_numpy(table).long())
    _same_pools(tview, jview, skip_trash=False)
    # the view is a copy: writing it leaves the pools alone
    tview["k"].add_(1.0)
    np.testing.assert_array_equal(tcache["k"].numpy(), pools["k"])
    tview = ta.view(tcache, torch.from_numpy(table).long())

    # one new row per lane, committed at each lane's length
    new = {k: rng.standard_normal(tview[k].shape).astype(np.float32)
           for k in ("k", "v")}
    for valid in ([True, True, False], [True, False, True]):
        jv = {**jview, **{k: jnp.asarray(v) for k, v in new.items()}}
        tv = {**tview, **{k: torch.from_numpy(v.copy())
                          for k, v in new.items()}}
        jout = ja.scatter_rows(jcache, jv, jnp.asarray(table),
                               jnp.asarray(lengths), jnp.asarray(valid))
        tout = dict(tcache, k=tcache["k"].clone(), v=tcache["v"].clone())
        ta.scatter_rows(tout, tv, torch.from_numpy(table).long(),
                        torch.from_numpy(lengths), torch.tensor(valid))
        _same_pools(tout, jout)
        changed = (tout["k"] != tcache["k"]).any(dim=(0, 2, 3))
        # lane 2 holds no pages: valid or not, it writes the trash row
        assert int(changed[1:].sum()) == sum(valid[:2])

    # admission insert of a 1-row prefill cache, with trash-mapped rows
    ja.cache = dict(jcache)
    ta.cache = dict(tcache, k=tcache["k"].clone(), v=tcache["v"].clone())
    req = {k: rng.standard_normal((2, 1, 32, 2, 32)).astype(np.float32)
           for k in ("k", "v")}
    req["length"] = np.array([11], np.int32)
    flat = np.zeros((32,), np.int32)
    flat[8:11] = [5 * 8 + 0, 5 * 8 + 1, 5 * 8 + 2]   # shared rows 0-7 trashed
    ja.insert({k: jnp.asarray(v) for k, v in req.items()}, 2, flat)
    ta.insert({k: torch.from_numpy(v) for k, v in req.items()}, 2,
              torch.from_numpy(flat).long())
    _same_pools(ta.cache, ja.cache)
    np.testing.assert_array_equal(ta.cache["length"].numpy(),
                                  np.asarray(ja.cache["length"]))
    assert ta.cache["length"].tolist() == [5, 17, 11]

    # copy-on-write page copies
    ja.copy_pages([3, 1], [6, 8])
    ta.copy_pages([3, 1], [6, 8])
    _same_pools(ta.cache, ja.cache, skip_trash=False)
    np.testing.assert_array_equal(ta.cache["v"][:, 48:56].numpy(),
                                  ta.cache["v"][:, 24:32].numpy())


# --- chunk_step against the JAX package's ---------------------------------

@pytest.mark.parametrize("mult", ["exact", "trunc2x2", "pareto:0.01"])
def test_chunk_step_matches_jax(mult):
    """A 4-token prefill, then chunks of 8 (the second with n_valid 6): the
    logits (masked positions too), K/V, lengths and greedy ids against the
    JAX package's `chunk_step`."""
    cj, ct, pj, pt = _setup(mult)
    max_len = 24
    sj, stt = japi.make_spec(cj), api.make_spec(ct, device="cpu")
    pjp, ptp = japi.prepare_params(pj, cj, sj), api.prepare_params(pt, ct,
                                                                   stt)
    toks = np.random.default_rng(3).integers(1, 512, (1, 20)).astype(
        np.int32)
    _, jc = jax.jit(lambda p, t: japi.prefill(
        p, t, cj, sj, max_len=max_len,
        true_len=jnp.asarray([4], jnp.int32)))(pjp, jnp.asarray(toks[:, :4]))
    _, tc = api.prefill(ptp, torch.from_numpy(toks[:, :4]).long(), ct, stt,
                        max_len=max_len,
                        true_len=torch.tensor([4], dtype=torch.int32))
    jchunk = jax.jit(lambda p, c, t, n: japi.chunk_step(p, c, t, cj, sj,
                                                        n_valid=n))
    for lo, n_valid in ((4, 8), (12, 6)):
        chunk = toks[:, lo:lo + 8]
        lj, jc = jchunk(pjp, jc, jnp.asarray(chunk),
                        jnp.asarray([n_valid], jnp.int32))
        lt, tc = api.chunk_step(ptp, tc, torch.from_numpy(chunk).long(), ct,
                                stt, n_valid=n_valid)
        assert lt.shape == (1, 8, ct.vocab)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=TOL,
                                   atol=TOL)
        for key in ("k", "v"):
            np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                       rtol=TOL, atol=TOL)
        np.testing.assert_array_equal(tc["length"].numpy(),
                                      np.asarray(jc["length"]))
        np.testing.assert_array_equal(lt[0, :n_valid].argmax(-1).numpy(),
                                      np.asarray(jnp.argmax(lj[0, :n_valid],
                                                            -1)))
    assert tc["length"].tolist() == [18]


def test_chunk_step_is_token_by_token_decode_bitwise():
    """The port's chunk_step against its own decode_step, token by token:
    logits at valid positions and the whole cache bit for bit; the masked
    tail leaves the cache as the valid steps left it."""
    _, ct, _, pt = _setup()
    spec = api.make_spec(ct, device="cpu")
    ptp = api.prepare_params(pt, ct, spec)
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        1, 512, (1, 12)))
    _, c0 = api.prefill(ptp, toks[:, :4], ct, spec, max_len=16,
                        true_len=torch.tensor([4], dtype=torch.int32))
    c1 = {k: v.clone() for k, v in c0.items()}
    lg, chunked = api.chunk_step(ptp, c0, toks[:, 4:12], ct, spec, n_valid=5)
    for i in range(5):
        li, c1 = api.decode_step(ptp, c1, toks[:, 4 + i:5 + i], ct, spec)
        assert torch.equal(lg[:, i], li[:, -1])
    for key in ("k", "v", "length"):
        assert torch.equal(chunked[key], c1[key]), key
    with pytest.raises(ValueError, match="single-request"):
        api.chunk_step(ptp, c1, toks[:, :2].repeat(2, 1), ct, spec)


# --- PagedEngine against the port's slot engine ---------------------------

PAGED_CASES = {
    "paged": dict(page_size=8),
    "chunked": dict(page_size=8, prefill_chunk=8),
    "exact-draft": dict(page_size=8, draft_tier="exact", spec_k=3),
    "trunc4x4-draft": dict(page_size=8, draft_tier="trunc4x4", spec_k=4),
    "stacked": dict(page_size=8, prefill_chunk=8, draft_tier="trunc4x4",
                    spec_k=3),
}


@pytest.mark.parametrize("case", sorted(PAGED_CASES))
def test_paged_engine_token_identical_to_slot_engine(case):
    """Greedy and seeded-sampled rows of the mixed-arrival trace, token for
    token and finish reason for finish reason."""
    kw = PAGED_CASES[case]
    eng = _differential(_mixed_trace(), **kw)
    st = eng.stats()
    assert st["paged"]["paged_leaves"] == ["k", "v"]
    assert st["paged"]["alloc_failures"] == 0
    assert (st["paged"]["chunked"]["chunks"] > 0) == ("prefill_chunk" in kw)
    if "draft_tier" in kw:
        assert st["spec"]["steps"] > 0 and st["spec"]["proposed"] > 0
        assert 0.0 <= st["spec"]["acceptance_rate"] <= 1.0
        for c in eng.completions:
            assert c.spec.accepted + c.spec.corrections == len(c.tokens)
    else:
        assert "spec" not in st
        assert all(c.spec is None for c in eng.completions)


def test_paged_engine_greedy_streams_match_jax_loop():
    """The slice end to end: chunked prefill and trunc4x4 speculation over
    test_torch_serving.py's mixed-arrival prompts, every greedy stream
    equal to the JAX package's solo prefill + decode loop."""
    cj, ct, pj, pt = _setup()
    spec = japi.make_spec(cj)
    params = japi.prepare_params(pj, cj, spec)
    pre = jax.jit(lambda p, t, n: japi.prefill(p, t, cj, spec, max_len=40,
                                               true_len=n))
    dec = jax.jit(lambda p, c, t: japi.decode_step(p, c, t, cj, spec))
    lens, seeds, gens = [5, 16, 9, 12], [0, 11, 2, 3], [6, 4, 5, 3]
    prompts = [_prompt(n, s) for n, s in zip(lens, seeds)]
    eng = PagedEngine(ct, pt, capacity=2, max_len=40, prefill_buckets=(16,),
                      page_size=8, prefill_chunk=8, draft_tier="trunc4x4",
                      spec_k=3, device="cpu")
    for i, (p, g) in enumerate(zip(prompts, gens)):
        eng.submit(Request(f"r{i}", p, SamplingParams(max_new_tokens=g),
                           arrival=[0.0, 0.0, 2.0, 3.0][i]))
    done = {c.request_id: c.tokens for c in eng.run_until_complete()}
    for i, (p, g) in enumerate(zip(prompts, gens)):
        padded = np.zeros((1, 16), np.int32)
        padded[0, :len(p)] = p
        lg, cache = pre(params, jnp.asarray(padded),
                        jnp.asarray([len(p)], jnp.int32))
        tok = jnp.argmax(lg, -1).astype(jnp.int32)[:, None]
        want = [int(tok[0, 0])]
        for _ in range(g - 1):
            lg, cache = dec(params, cache, tok)
            tok = jnp.argmax(lg[:, -1], -1).astype(jnp.int32)[:, None]
            want.append(int(tok[0, 0]))
        assert done[f"r{i}"] == want, (i, done[f"r{i}"], want)
    assert eng.stats()["paged"]["chunked"]["chunks"] > 0


def test_chunked_prefill_interleaves_with_decode():
    """A long prompt prefills in chunks while a short request decodes: the
    short request's first token lands before the long prompt finishes
    prefilling, with streams unchanged."""
    trace = [Request("long", _prompt(40, 0), SamplingParams(max_new_tokens=4)),
             Request("short", _prompt(4, 1), SamplingParams(max_new_tokens=4))]
    base = _serve(_engine(Engine, capacity=2, max_len=64), list(trace))
    eng = _engine(PagedEngine, capacity=2, max_len=64, page_size=8,
                  prefill_chunk=8, chunk_budget=1)
    for req in trace:
        eng.submit(req)
    short_first_tick = None
    while eng.n_queued or eng.n_active:
        eng.step()
        done = {c.request_id for c in eng.completions}
        slot_tokens = {s.request.request_id: len(s.tokens)
                       for s in eng._slots if s is not None}
        if short_first_tick is None and (
                slot_tokens.get("short", 0) > 0 or "short" in done):
            short_first_tick = eng.tick
            assert eng.stats()["paged"]["chunked"]["inflight"] == 1
    got = {c.request_id: (c.tokens, c.finish_reason)
           for c in eng.completions}
    assert got == base
    assert short_first_tick is not None
    assert eng.stats()["paged"]["chunked"]["chunks"] >= 5   # 40 / 8


def test_prefix_sharing_differential_and_hits():
    system = _prompt(24, 9)
    trace = [Request(f"s{i}", system + _prompt(4, 50 + i),
                     SamplingParams(max_new_tokens=4), arrival=float(i))
             for i in range(4)]
    eng = _differential(trace, capacity=2, page_size=8)
    st = eng.stats()["paged"]
    assert st["prefix_hits"] >= 1
    assert st["prefix_hit_tokens"] >= 16     # >= 2 shared pages per hit


def test_page_pressure_stalls_preserve_fifo():
    """A pool too small for full concurrency stalls admission at the queue
    head (no overtaking); every request still completes with the slot
    engine's tokens."""
    trace = [Request(f"p{i}", _prompt(20, 60 + i),
                     SamplingParams(max_new_tokens=4)) for i in range(4)]
    eng = _differential(trace, capacity=3, max_len=32, page_size=8,
                        n_pages=6, prefix_cache=False)
    assert eng.stats()["paged"]["admission_stalls"] > 0
    done = {c.request_id: c for c in eng.completions}
    assert sorted(done, key=lambda r: done[r].admitted_tick) == \
        [f"p{i}" for i in range(4)]


def test_pool_fit_validation():
    eng = _engine(PagedEngine, capacity=1, max_len=32, page_size=8,
                  n_pages=3)
    with pytest.raises(ValueError, match="pages"):
        eng.submit(Request("big", _prompt(20, 0),
                           SamplingParams(max_new_tokens=8)))
    with pytest.raises(ValueError, match="spec_k"):
        _engine(PagedEngine, capacity=1, max_len=32, draft_tier="exact",
                spec_k=0)


def test_cow_resolves_shared_page():
    """resolve_cow on a prefix-shared page: a private copy with identical
    content, allocator invariants intact; a private page needs no copy."""
    eng = _engine(PagedEngine, capacity=2, max_len=64, page_size=8)
    system = _prompt(16, 3)
    eng.submit(Request("a", system + [5], SamplingParams(max_new_tokens=12)))
    eng.submit(Request("b", system + [9], SamplingParams(max_new_tokens=12)))
    for _ in range(3):
        eng.step()
    assert eng._leases["b"].shared_pages == 2
    before = eng.debug_kv_rows("b")
    assert not eng._alloc.writable("b", 0)
    op = eng.resolve_cow("b", 0)
    assert op is not None and op[1] != op[0]
    assert eng._alloc.writable("b", 0)
    after = eng.debug_kv_rows("b")
    for key in before["rows"]:
        np.testing.assert_array_equal(before["rows"][key][:8],
                                      after["rows"][key][:8])
    eng._alloc.audit()
    assert eng.resolve_cow("b", 0) is None


# --- speculative-decode invariants ----------------------------------------

@pytest.mark.parametrize("mult", ["exact", "trunc2x2"])
def test_serving_tier_draft_accepts_everything(mult):
    """Drafting with the serving tier itself accepts every proposal."""
    eng = _engine(PagedEngine, mult, capacity=2, max_len=64, page_size=8,
                  draft_tier=mult, spec_k=4)
    for i in range(3):
        eng.submit(Request(f"g{i}", _prompt(6 + 4 * i, i),
                           SamplingParams(max_new_tokens=9)))
    done = eng.run_until_complete()
    spec = eng.stats()["spec"]
    assert spec["proposed"] > 0
    assert spec["accepted"] == spec["proposed"]
    assert spec["acceptance_rate"] == 1.0
    for c in done:
        assert c.spec.accepted + c.spec.corrections == len(c.tokens)
        assert c.spec.proposed == c.spec.accepted


def test_sampled_rows_bypass_speculation():
    eng = _engine(PagedEngine, capacity=1, max_len=48, page_size=8,
                  draft_tier="exact", spec_k=4)
    eng.submit(Request("hot", _prompt(6, 2),
                       SamplingParams(temperature=0.9, top_k=8,
                                      max_new_tokens=6, seed=5)))
    (c,) = eng.run_until_complete()
    assert c.spec.proposed == 0 and c.spec.accepted == 0
    assert c.spec.corrections == len(c.tokens) == 6
    assert c.spec.acceptance_rate == 0.0


def test_rejected_drafts_never_leak_into_kv_pages():
    """Mid-flight, every reserved-but-unwritten KV position of every active
    request is still zero: rejected speculative positions went to the
    trash page."""
    eng = _engine(PagedEngine, capacity=2, max_len=64, page_size=8,
                  draft_tier="trunc4x4", spec_k=4, prefix_cache=False)
    for i in range(2):
        eng.submit(Request(f"r{i}", _prompt(10 + 5 * i, 30 + i),
                           SamplingParams(max_new_tokens=12)))
    rejections = 0
    while eng.n_queued or eng.n_active:
        eng.step()
        spec = eng.stats()["spec"]
        rejections = spec["proposed"] - spec["accepted"]
        for slot in eng._slots:
            if slot is None or slot.prefilling:
                continue
            d = eng.debug_kv_rows(slot.request.request_id)
            assert d["length"] <= d["reserved"]
            for key, rows in d["rows"].items():
                assert not np.any(rows[d["length"]:d["reserved"]]), \
                    f"{key}: rejected draft leaked into KV pages"
    assert rejections > 0


def test_spec_stats_conserve_under_chaos_burst_schedule():
    """`accepted + corrections == len(tokens)` for every completion of the
    reference's chaos-seeded burst trace, greedy and sampled rows mixed,
    with zero lost and zero duplicated requests."""
    from repro.fleet.chaos import ChaosSchedule
    sched = ChaosSchedule.random(17, ["e0"], kinds=("burst",), n_events=3,
                                 horizon_ticks=10)
    eng = _engine(PagedEngine, capacity=3, max_len=48, page_size=8,
                  prefill_chunk=8, draft_tier="trunc4x4", spec_k=3)
    submitted, rid = [], 0
    for ev in sched.events:
        for _ in range(ev.n_requests):
            sp = SamplingParams(max_new_tokens=2 + rid % 4) \
                if rid % 3 else SamplingParams(
                    temperature=0.8, top_k=8, max_new_tokens=3, seed=rid)
            eng.submit(Request(f"b{rid}", _prompt(4 + rid % 14, rid), sp,
                               arrival=float(ev.tick)))
            submitted.append(f"b{rid}")
            rid += 1
    done = eng.run_until_complete()
    ids = [c.request_id for c in done]
    assert sorted(ids) == sorted(submitted) and len(set(ids)) == len(ids)
    for c in done:
        assert c.spec.accepted + c.spec.corrections == len(c.tokens), c
    tot = eng.stats()["spec"]
    assert tot["accepted"] + tot["corrections"] == \
        sum(len(c.tokens) for c in done)
    eng._alloc.audit()
    assert eng._alloc.pages_live == 0


def test_deadline_evicts_a_prefilling_request_and_frees_its_pages():
    eng = _engine(PagedEngine, capacity=2, max_len=64, page_size=8,
                  prefill_chunk=8)
    eng.submit(Request("slow", _prompt(40, 4),
                       SamplingParams(max_new_tokens=4),
                       deadline_ticks=3.0))
    eng.submit(Request("ok", _prompt(6, 5), SamplingParams(max_new_tokens=3)))
    done = {c.request_id: c for c in eng.run_until_complete()}
    assert done["slow"].finish_reason == "deadline"
    assert done["slow"].tokens == []
    assert done["ok"].finish_reason == "length"
    eng._alloc.audit()
    assert eng._alloc.pages_live == 0


def test_scheduler_peek_ready_does_not_pop():
    s = Scheduler()
    s.submit(Request("b", [1], arrival=2.0))
    s.submit(Request("a", [1], arrival=0.0))
    assert s.peek_ready(0.0).request_id == "a"
    assert s.peek_ready(0.0).request_id == "a" and len(s) == 2
    assert s.pop_ready(0.0).request_id == "a"
    assert s.peek_ready(1.0) is None and s.peek_ready(2.0).request_id == "b"


def test_chunked_prefill_tie_moves_one_int8_code(monkeypatch):
    """Why a chunked prefill may leave the slot engine's stream on rare
    prompts: the first chunk's attention (32 queries) and `chunk_step`'s
    decode attention round differently in f32 from the attention over the
    whole bucket, and an attention output lying at a .5 rounding boundary
    of its quantizer lands on either side.  On this prompt (1 of 30 seeds
    at this shape) every int8 code agrees until layer 0's o-projection
    input, where exactly one code moves, at position 41; its x / scale
    lies within a few f32 ulps of one .5 boundary on both paths, the two
    attention outputs agreeing to 5e-7 of the row's absmax.  A fault of
    the chunk path would move codes away from such ties (ROADMAP.md Queue
    3).  The procedure also finds the first moved code of a full-width
    chunked prompt on the card."""
    from repro_torch.approx import gemm as TG
    _, ct, _, pt = _setup()
    spec = api.make_spec(ct, device="cpu")
    ptp = api.prepare_params(pt, ct, spec)
    toks = torch.tensor([_prompt(48, 27)])
    rec, quant = [], TG._quantize_activations

    def record(x2, spec_, use_kernels):
        q, s = quant(x2, spec_, use_kernels)
        rec.append([t.numpy().copy() for t in (x2, q, s)])
        return q, s

    monkeypatch.setattr(TG, "_quantize_activations", record)
    padded = torch.zeros((1, 128), dtype=torch.long)
    padded[0, :48] = toks[0]
    api.prefill(ptp, padded, ct, spec, max_len=256,
                true_len=torch.tensor([48], dtype=torch.int32))
    whole, rec[:] = list(rec), []
    _, ws = api.prefill(ptp, toks[:, :32], ct, spec, max_len=256,
                        true_len=torch.tensor([32], dtype=torch.int32))
    api.chunk_step(ptp, ws, toks[:, 32:], ct, spec)   # the engine's path
    per = 7 * ct.n_layers + 1                  # the GEMMs, then the head
    assert len(whole) == per and len(rec) == per + 16 * per

    def chunked_row(g, r):        # (x row, scale) of position r, chunked
        x, _, sc = rec[g] if r < 32 else rec[per + (r - 32) * per + g]
        i = r if r < 32 else 0
        return x[i], sc[i, 0]

    moved = []
    for g in range(per - 1):
        q = np.concatenate([rec[g][1]] + [rec[per + j * per + g][1]
                                          for j in range(16)])
        moved.append(np.argwhere(q != whole[g][1][:48]))
    first = next(g for g, m in enumerate(moved) if len(m))
    assert first == 3                          # layer 0, o-projection input
    (r, c), = moved[first].tolist()
    assert r == 41
    xc, sc = chunked_row(first, r)
    xw, sw = whole[first][0][r], whole[first][2][r, 0]
    assert abs(float(xw[c]) - float(xc[c])) <= 5e-7 * 127 * float(sw)
    # x / scale of both paths within a few f32 ulps of the same .5
    # boundary, which the f32 quotient rounds to on one path only
    vw = np.float64(xw[c]) / np.float64(sw)
    vc = np.float64(xc[c]) / np.float64(sc)
    tie = np.floor(min(vw, vc)) + 0.5
    for v in (vw, vc):
        assert abs(v - tie) <= 8 * np.spacing(np.float32(tie)), (vw, vc)
    qw = np.rint(np.float32(xw[c]) / np.float32(sw))
    qc = np.rint(np.float32(xc[c]) / np.float32(sc))
    assert abs(qw - qc) == 1       # before the trunc2x2 mask
