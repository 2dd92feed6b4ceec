"""repro_torch's slot Engine on the CPU.

Greedy streams over a mixed-arrival trace are held against a plain greedy
loop over the JAX package's `api.prefill` / `api.decode_step` (called
outside any sharding-rules context), on the same params.  The lifecycle
behaviours (slot reuse, deadlines and shedding, tiers, EOS, streaming,
validation) mirror tests/test_serving.py.
"""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro import configs as jconfigs
from repro.models import api as japi
from repro_torch import configs
from repro_torch.models import weights
from repro_torch.serving import Engine, Request, SamplingParams
from repro_torch.serving.sampling import sample_tokens
from repro_torch.serving.scheduler import Scheduler

OVER = dict(mult="trunc2x2", kernel_policy="pallas", attn_impl="flash")
MAX_LEN = 40
BUCKET = 16

# Pin torch's CPU pool: the test workers share the cores, and a fixed
# thread count keeps the order of CPU reductions the same everywhere.
torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _setup():
    cj = jconfigs.reduced(jconfigs.get_config("tinyllama-1.1b"), **OVER)
    ct = configs.reduced(configs.get_config("tinyllama-1.1b"), **OVER)
    pj = japi.init_params(cj, jax.random.key(0))
    pt = weights.from_reference(jax.tree_util.tree_map(np.asarray, pj), ct,
                                "cpu")
    return cj, ct, pj, pt


def _prompt(n, seed, vocab=512):
    return np.random.default_rng(seed).integers(1, vocab, (n,)).tolist()


def _jax_greedy(prompts: dict, gens: dict) -> dict:
    """The reference loop: each request alone, right-padded to the bucket,
    prefill then greedy decode, jitted."""
    cj, _, pj, _ = _setup()
    spec = japi.make_spec(cj)
    params = japi.prepare_params(pj, cj, spec)
    pre = jax.jit(lambda p, t, n: japi.prefill(p, t, cj, spec,
                                               max_len=MAX_LEN, true_len=n))
    dec = jax.jit(lambda p, c, t: japi.decode_step(p, c, t, cj, spec))
    out = {}
    for rid, toks in prompts.items():
        padded = np.zeros((1, BUCKET), np.int32)
        padded[0, :len(toks)] = toks
        lg, cache = pre(params, jnp.asarray(padded),
                        jnp.asarray([len(toks)], jnp.int32))
        tok = jnp.argmax(lg, -1).astype(jnp.int32)[:, None]
        stream = [int(tok[0, 0])]
        for _ in range(gens[rid] - 1):
            lg, cache = dec(params, cache, tok)
            tok = jnp.argmax(lg[:, -1], -1).astype(jnp.int32)[:, None]
            stream.append(int(tok[0, 0]))
        out[rid] = stream
    return out


def _engine(capacity=2, **kw):
    _, ct, _, pt = _setup()
    return Engine(ct, pt, capacity=capacity, max_len=MAX_LEN,
                  prefill_buckets=(BUCKET,), device="cpu", **kw)


def test_mixed_arrival_trace_matches_jax_greedy_loop():
    """Four requests through two slots: two at tick 0, one joining mid-
    decode, one waiting for a freed slot.  Every stream equals the JAX
    package's solo greedy loop.

    f32 ops that each framework rounds its own way (rsqrt, reductions)
    differ by an ulp, and on rare inputs such an ulp moves an int8
    activation across a rounding boundary; the prompt of seed 1 at length
    16 is one (ROADMAP.md Queue 3, pinned by the next test), and these
    prompts are not."""
    lens, seeds = [5, 16, 9, 12], [0, 11, 2, 3]
    gens = {"r0": 6, "r1": 4, "r2": 5, "r3": 3}
    arrivals = [0.0, 0.0, 2.0, 3.0]
    prompts = {f"r{i}": _prompt(n, s)
               for i, (n, s) in enumerate(zip(lens, seeds))}
    streamed = []
    eng = _engine(on_token=lambda rid, t: streamed.append((rid, t)))
    for i, rid in enumerate(prompts):
        eng.submit(Request(rid, prompts[rid],
                           SamplingParams(max_new_tokens=gens[rid]),
                           arrival=arrivals[i]))
    done = {c.request_id: c for c in eng.run_until_complete()}
    want = _jax_greedy(prompts, gens)
    for rid in prompts:
        assert done[rid].tokens == want[rid], (rid, done[rid].tokens,
                                               want[rid])
        assert done[rid].finish_reason == "length"
    assert done["r2"].admitted_tick >= 2
    assert done["r2"].admitted_tick < done["r0"].finished_tick  # joined
    assert done["r3"].admitted_tick >= min(done["r0"].finished_tick,
                                           done["r1"].finished_tick)
    assert sorted(streamed) == sorted(
        (rid, t) for rid in prompts for t in done[rid].tokens)
    st = eng.stats()
    assert st["admitted"] == 4 and st["completed"] == 4
    assert st["evictions"] == {"eos": 0, "length": 4}
    assert st["queue_wait_ticks_total"] > 0
    assert st["device"] == "cpu"


def test_seed1_divergence_is_one_int8_rounding_tie(monkeypatch):
    """The prompt the trace above avoids, with the witness of why: every
    activation quantizer of its prefill is recorded in both packages.  All
    int8 codes agree until layer 0's FFN down projection, and there exactly
    one code differs, at position 9.  Its x / scale lies on opposite sides
    of a .5 rounding boundary in the two packages while the two f32 values
    agree to a few ulps, and that GEMM's inputs and row scales agree to
    f32 rounding.  A port fault would move codes away from such ties."""
    from repro.approx import gemm as JG
    from repro_torch.approx import gemm as TG
    from repro_torch.models import api

    cj, ct, pj, pt = _setup()
    toks = _prompt(BUCKET, 1)
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
    jspec = japi.make_spec(cj)
    jax.jit(lambda p, t, n: japi.prefill(p, t, cj, jspec, max_len=MAX_LEN,
                                         true_len=n))(
        japi.prepare_params(pj, cj, jspec), jnp.asarray([toks], jnp.int32),
        jnp.asarray([BUCKET], jnp.int32))
    jax.effects_barrier()
    tspec = api.make_spec(ct, device="cpu")
    api.prefill(api.prepare_params(pt, ct, tspec), torch.tensor([toks]), ct,
                tspec, max_len=MAX_LEN,
                true_len=torch.tensor([BUCKET], dtype=torch.int32))

    # q, k, v, o, gate, up, down per layer, then the LM head
    assert len(jrec) == len(trec) == 7 * ct.n_layers + 1
    first = next(i for i, (j, t) in enumerate(zip(jrec, trec))
                 if not np.array_equal(j[1], t[1]))
    assert first == 6                          # layer 0, down projection
    (xj, qj, sj), (xt, qt, st) = jrec[first], trec[first]
    np.testing.assert_allclose(xt, xj, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(st, sj, rtol=1e-6)      # a few ulps
    (r, c), = np.argwhere(qj != qt).tolist()
    assert r == 9
    vj = np.float64(xj[r, c]) / np.float64(sj[r, 0])
    vt = np.float64(xt[r, c]) / np.float64(st[r, 0])
    assert abs(vj - vt) <= 8 * np.spacing(np.float32(vt))
    tie = np.floor(min(vj, vt)) + 0.5
    assert min(vj, vt) < tie < max(vj, vt), (vj, vt)


def test_eos_and_deadline_eviction():
    eng = _engine(capacity=1)
    ref = _jax_greedy({"e": _prompt(9, 5)}, {"e": 8})["e"]
    eos = ref[3]
    eng.submit(Request("e", _prompt(9, 5),
                       SamplingParams(max_new_tokens=8, eos_id=eos)))
    eng.submit(Request("d", _prompt(8, 3), SamplingParams(max_new_tokens=12),
                       arrival=20.0, deadline_ticks=5.0))
    done = {c.request_id: c for c in eng.run_until_complete()}
    assert done["e"].finish_reason == "eos"
    assert done["e"].tokens == ref[:ref.index(eos) + 1]
    d = done["d"]
    assert d.finish_reason == "deadline" and 0 < len(d.tokens) < 12
    assert d.finished_tick - d.arrival + 1 <= 5


def test_ttft_deadline_sheds():
    eng = _engine(capacity=1)
    eng.submit(Request("hog", _prompt(8, 0), SamplingParams(max_new_tokens=6)))
    eng.submit(Request("tight", _prompt(8, 1), SamplingParams(max_new_tokens=2),
                       ttft_deadline_ticks=2.0))
    eng.submit(Request("patient", _prompt(8, 2),
                       SamplingParams(max_new_tokens=2),
                       ttft_deadline_ticks=64.0))
    done = {c.request_id: c for c in eng.run_until_complete()}
    assert done["tight"].finish_reason == "shed"
    assert done["tight"].tokens == [] and done["tight"].admitted_tick == -1
    assert done["patient"].finish_reason == "length"
    assert eng.stats()["evictions"]["shed"] == 1
    assert eng.pending_requests() == [] and not eng.active_request_ids()


def test_tier_ladder_switch_attributes_tokens():
    eng = _engine(capacity=1, tiers=("exact", "trunc4x4"))
    assert eng.tier == "exact"
    eng.submit(Request("t", _prompt(8, 7), SamplingParams(max_new_tokens=6)))
    for _ in range(3):
        eng.step()
    eng.set_tier("trunc4x4")
    assert eng.tier_index == 1
    (c,) = eng.run_until_complete()
    assert c.tier_tokens["exact"] > 0 and c.tier_tokens["trunc4x4"] > 0
    assert sum(c.tier_tokens.values()) == len(c.tokens) == 6
    st = eng.stats()["tiers"]
    assert len(st["switches"]) == 1 and st["tokens"] == c.tier_tokens
    with pytest.raises(ValueError, match="unknown tier"):
        eng.set_tier("trunc9x9")


def test_sampling_per_slot_generators():
    def run():
        eng = _engine(capacity=3, seed=7)
        prompt = _prompt(10, 42)
        eng.submit(Request("greedy", prompt, SamplingParams(max_new_tokens=5)))
        eng.submit(Request("topk1", prompt, SamplingParams(
            temperature=1.7, top_k=1, max_new_tokens=5)))
        eng.submit(Request("hot", prompt, SamplingParams(
            temperature=1.0, top_k=8, max_new_tokens=5, seed=123)))
        return {c.request_id: c.tokens for c in eng.run_until_complete()}

    a = run()
    assert a["topk1"] == a["greedy"]
    assert run()["hot"] == a["hot"]
    logits = torch.from_numpy(
        np.random.default_rng(0).standard_normal((3, 64)).astype(np.float32))
    gens = [None, torch.Generator().manual_seed(0),
            torch.Generator().manual_seed(1)]
    toks = sample_tokens(logits, [0.0, 1.0, 1.0], [0, 1, 4], gens)
    assert toks[0] == logits[0].argmax() and toks[1] == logits[1].argmax()
    assert int(toks[2]) in logits[2].topk(4).indices.tolist()


def test_submit_validation_and_scheduler():
    eng = _engine(capacity=1)
    with pytest.raises(ValueError):
        eng.submit(Request("x", []))
    with pytest.raises(ValueError):
        eng.submit(Request("y", [1] * (BUCKET + 1)))
    with pytest.raises(ValueError):
        eng.submit(Request("z", [1] * 10, SamplingParams(max_new_tokens=40)))
    with pytest.raises(ValueError, match="ttft_deadline_ticks"):
        eng.submit(Request("a", [1, 2], ttft_deadline_ticks=0.0))
    with pytest.raises(ValueError, match="extras"):
        eng.submit(Request("f", [1, 2], extras={"frames": np.zeros(3)}))
    eng.submit(Request("ok", [1, 2], SamplingParams(max_new_tokens=2)))
    with pytest.raises(ValueError):
        eng.submit(Request("ok", [3, 4]))
    s = Scheduler()
    s.submit(Request("b", [1], arrival=2.0))
    s.submit(Request("a", [1], arrival=0.0))
    assert s.pop_ready(0.0).request_id == "a" and s.pop_ready(0.0) is None
    assert s.next_arrival() == 2.0
