"""Engine checks shared by tests/test_torch_ssm.py,
tests/test_torch_hybrid.py, tests/test_torch_encdec.py and
tests/test_torch_vision.py: the port's slot and paged engines on a family
whose cache is partly or wholly dense per-slot state, or whose requests
carry conditioning (`Request.extras`: frames, image embeddings, seeded
per request by `conditioning`), on the CPU at a reduced size.

  * the slot engine's greedy streams equal lone per-request decoding
    (one request at a time, prefill at the same bucket, then greedy
    decode at batch 1);
  * `PagedEngine` runs token-identical to the slot engine on the
    mixed-arrival trace of tests/test_torch_paged.py (greedy and seeded
    sampled rows);
  * a draft leaves the arena's dense leaves bit-equal, and a verify step
    leaves a frozen lane's dense state and length bit-equal while each
    live lane gets the state of its last emitted position.

And `reference_dtypes_kept`: `weights.from_reference` keeps the leaves
the reference keeps f32 in a bf16 model.
"""

import jax
import numpy as np
import torch

from repro import configs as jconfigs
from repro.models import api as japi
from repro_torch import configs
from repro_torch.models import api, weights
from repro_torch.serving import Engine, PagedEngine, Request, SamplingParams

PAGED_CASES = {
    "P": dict(page_size=8),
    "PC": dict(page_size=8, prefill_chunk=8),
    "PS": dict(page_size=8, draft_tier="trunc2x2", spec_k=3),
}


def prompt(n: int, seed: int, vocab: int) -> list:
    return np.random.default_rng(seed).integers(1, vocab, (n,)).tolist()


def conditioning(cfg, seed: int, batch: int | None = None) -> dict | None:
    """Seeded random extras for one request of `cfg` (a batch of them,
    with a leading axis, given `batch`; None for a config that takes
    none): frames of unit variance, image embeddings of 0.1, as the data
    pipeline's `frames_batch` / `img_batch` draw them."""
    shapes = api.extras_shapes(cfg)
    if not shapes:
        return None
    rng = np.random.default_rng(seed)
    lead = () if batch is None else (batch,)
    scale = {"frames": 1.0, "img_embeds": 0.1}
    return {key: (rng.standard_normal((*lead, *shape)) * scale[key]).astype(
        np.float32) for key, shape in sorted(shapes.items())}


def mixed_trace(vocab: int, n_requests: int = 8, seed: int = 1,
                cfg=None) -> list:
    """Heterogeneous prompt lengths (4-23), staggered arrivals, greedy and
    seeded sampled rows alternating; with a `cfg` that takes extras, each
    request carries its own seeded `conditioning`."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_requests):
        n = int(rng.integers(4, 24))
        gen = int(rng.integers(2, 6))
        sp = SamplingParams(max_new_tokens=gen) if i % 2 == 0 else \
            SamplingParams(temperature=0.9, top_k=8, max_new_tokens=gen,
                           seed=100 + i)
        out.append(Request(f"t{i}", rng.integers(1, vocab, (n,)).tolist(),
                           sp, arrival=float(i) * 0.7,
                           extras=None if cfg is None
                           else conditioning(cfg, 10_000 + i)))
    return out


def serve(engine, trace) -> dict:
    for req in trace:
        engine.submit(req)
    return {c.request_id: (c.tokens, c.finish_reason)
            for c in engine.run_until_complete()}


def slot_engine_equals_lone_decoding(cfg, params) -> None:
    """Five greedy requests through three slots (two join mid-decode, one
    waits for a freed slot) against each request decoded alone, each with
    its own `conditioning` where the config takes it."""
    bucket, max_len = 24, 40
    lens, gens = [5, 23, 9, 14, 11], [6, 4, 5, 3, 7]
    arrivals = [0.0, 0.0, 0.0, 2.0, 3.0]
    prompts = [prompt(n, 10 + i, cfg.vocab) for i, n in enumerate(lens)]
    extras = [conditioning(cfg, 10_000 + i) for i in range(len(lens))]
    eng = Engine(cfg, params, capacity=3, max_len=max_len,
                 prefill_buckets=(bucket,), device="cpu")
    for i, (p, g, t) in enumerate(zip(prompts, gens, arrivals)):
        eng.submit(Request(f"r{i}", p, SamplingParams(max_new_tokens=g),
                           arrival=t, extras=extras[i]))
    done = {c.request_id: c.tokens for c in eng.run_until_complete()}
    spec = api.make_spec(cfg, device="cpu")
    prepared = api.prepare_params(params, cfg, spec)
    for i, (p, g) in enumerate(zip(prompts, gens)):
        padded = torch.zeros((1, bucket), dtype=torch.long)
        padded[0, :len(p)] = torch.tensor(p)
        ex = {k: torch.from_numpy(v)[None]
              for k, v in (extras[i] or {}).items()}
        logits, cache = api.prefill(prepared, padded, cfg, spec,
                                    max_len=max_len, extras=ex,
                                    true_len=torch.tensor([len(p)]))
        tok = logits.argmax(-1)[:, None]
        stream = [int(tok)]
        for _ in range(g - 1):
            logits, cache = api.decode_step(prepared, cache, tok, cfg, spec,
                                            ex)
            tok = logits[:, -1].argmax(-1)[:, None]
            stream.append(int(tok))
        assert done[f"r{i}"] == stream, (i, done[f"r{i}"], stream)
    assert eng.stats()["admitted"] == 5


def paged_equals_slot_engine(cfg, params, case: str,
                             paged_leaves: tuple = ()) -> None:
    """`PagedEngine` against the slot engine on `mixed_trace` (with each
    request's conditioning where the config takes it); `paged_leaves` are
    the cache leaves that page (none of a recurrent cache)."""
    kw = PAGED_CASES[case]
    trace = mixed_trace(cfg.vocab, cfg=cfg)
    base = serve(Engine(cfg, params, capacity=3, max_len=64, device="cpu"),
                 list(trace))
    eng = PagedEngine(cfg, params, capacity=3, max_len=64, device="cpu",
                      **kw)
    assert serve(eng, list(trace)) == base, case
    eng._alloc.audit()
    assert eng._alloc.pages_live == 0
    st = eng.stats()
    assert st["paged"]["paged_leaves"] == sorted(paged_leaves)
    assert (st["paged"]["chunked"]["chunks"] > 0) == ("prefill_chunk" in kw)
    if "draft_tier" in kw:
        assert st["spec"]["acceptance_rate"] == 1.0
        for c in eng.completions:
            assert c.spec.accepted + c.spec.corrections == len(c.tokens)


def _lane(t: torch.Tensor, axis: int, lane: int) -> torch.Tensor:
    return t.narrow(axis, lane, 1)


def draft_and_verify_keep_dense_state(cfg, params) -> None:
    """Three greedy lanes mid-decode.  The draft leaves the arena as it
    was.  Verify with k_row (2, 0, 1) under a draft tier equal to the
    serving tier (every draft accepted): lane 0 ends at the state of two
    plain decode steps, lane 2 at one, and frozen lane 1 as it was, bit
    for bit."""
    eng = PagedEngine(cfg, params, capacity=3, max_len=64, page_size=8,
                      draft_tier=cfg.mult, spec_k=3, device="cpu")
    for i, n in enumerate((12, 7, 9)):
        eng.submit(Request(f"r{i}", prompt(n, 20 + i, cfg.vocab),
                           SamplingParams(max_new_tokens=12)))
    eng.step()                      # admit all three, one spec step
    arena = eng._arena
    dense = eng._dense
    assert dense and not arena.paged
    before = {k: v.clone() for k, v in arena.cache.items()}

    draft = eng._draft_tokens()
    for key in dense:
        assert torch.equal(arena.cache[key], before[key]), key

    # the plain decode steps the verify must reproduce, on copies
    tok = eng._tok
    states = [before]
    for i in range(2):
        cache = {k: v.clone() for k, v in states[-1].items()}
        _, cache = api.decode_step(eng.exec_params, cache, tok, cfg,
                                   eng._spec)
        states.append(cache)
        tok = draft[:, i:i + 1]

    _, m, a = eng._verify(draft, np.array([2, 0, 1]))
    assert m.tolist() == [2, 0, 1] and a.tolist() == [2, 0, 1]
    after = arena.cache
    assert (after["length"] - before["length"]).tolist() == [2, 0, 1]
    for lane, steps in ((0, 2), (1, 0), (2, 1)):
        for key in dense:
            ax = arena.slot_axes[key]
            assert torch.equal(_lane(after[key], ax, lane),
                               _lane(states[steps][key], ax, lane)), (
                key, lane)


def reference_dtypes_kept(arch: str, f32: tuple) -> None:
    """In a bf16 model the leaves named in `f32` are f32 in the reference
    and in the port's tree (from `from_reference` and from the port's own
    init), every other float leaf bf16, values equal."""
    cj = jconfigs.reduced(jconfigs.get_config(arch), dtype="bfloat16",
                          n_layers=4)
    ct = configs.reduced(configs.get_config(arch), dtype="bfloat16",
                         n_layers=4)
    pj = jax.tree_util.tree_map(np.asarray,
                                japi.init_params(cj, jax.random.key(0)))
    pt = weights.from_reference(pj, ct, "cpu")
    own = api.init_params(ct, 0, "cpu")
    seen = set()
    for path, arr in jax.tree_util.tree_flatten_with_path(pj)[0]:
        keys = [k.key for k in path]
        leaf, mine = pt, own
        for k in keys:
            leaf, mine = leaf[k], mine[k]
        want = torch.float32 if keys[-1] in f32 else torch.bfloat16
        assert str(arr.dtype) == str(want).split(".")[-1], (keys, arr.dtype)
        assert leaf.dtype == mine.dtype == want, (keys, leaf.dtype)
        assert leaf.shape == mine.shape == arr.shape, keys
        np.testing.assert_array_equal(leaf.float().numpy(),
                                      arr.astype(np.float32))
        seen.add(keys[-1])
    assert set(f32) <= seen
