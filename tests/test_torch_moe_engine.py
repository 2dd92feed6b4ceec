"""The MoE family (reduced grok-1 and llama4-maverick) through the port's
slot and paged engines on the CPU, held against the port's own slot
engine (the reference engines do not run on this JAX; shared checks in
tests/torch_engine_checks.py).

The rows of an MoE decode call share its expert capacity
(tests/test_torch_moe.py pins that the reference couples them so), and
that decides which identities hold:

  * P (paged, prefix cache) equals the slot engine: both put the same
    rows in every decode call, each idle lane quiet (token 0 at length
    0, `Engine._quiet_idle_lanes`), whatever the lane held before;
  * PC (interleaved chunks) and PS (verify steps, admissions between
    spec steps) put other rows beside a token than the slot engine does,
    so they are held to it on a copy of the config whose capacity drops
    nothing (capacity_factor = e / top_k), as is the slot engine to lone
    decoding (on the real config a verify step's frozen lane takes
    capacity a draft step did not give it, so drafting with the serving
    tier itself no longer accepts every draft).
"""

import numpy as np
import pytest
import torch

import torch_engine_checks as E
from repro_torch import configs
from repro_torch.models import api, moe
from repro_torch.serving import Engine, PagedEngine, Request, SamplingParams

ARCHS = ("grok-1-314b", "llama4-maverick-400b-a17b")

torch.set_num_threads(1)


def _cfg(arch: str, drops: bool = True):
    cfg = configs.reduced(configs.get_config(arch), mult="trunc2x2",
                          kernel_policy="pallas")
    return cfg if drops else moe.no_drop(cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_engine_equals_slot_engine(arch):
    cfg = _cfg(arch)
    E.paged_equals_slot_engine(cfg, api.init_params(cfg, 0, "cpu"), "P",
                               paged_leaves=("k", "v"))


@pytest.mark.parametrize("case", sorted(E.PAGED_CASES))
@pytest.mark.parametrize("arch", ARCHS)
def test_paged_engine_without_drops_equals_slot_engine(arch, case):
    cfg = _cfg(arch, drops=False)
    E.paged_equals_slot_engine(cfg, api.init_params(cfg, 0, "cpu"), case,
                               paged_leaves=("k", "v"))


@pytest.mark.parametrize("arch", ARCHS)
def test_slot_engine_without_drops_equals_lone_decoding(arch):
    cfg = _cfg(arch, drops=False)
    E.slot_engine_equals_lone_decoding(cfg, api.init_params(cfg, 0, "cpu"))


@pytest.mark.parametrize("arch", ARCHS)
def test_a_frozen_lanes_token_moves_live_rows(arch):
    """Why PS is not held to the slot engine on the real config: a verify
    step feeds a frozen lane its old token where the draft step fed it
    the drafted one.  The same decode call with only lane 0's token
    changed (4 for its greedy token) moves the other lanes' logits, since
    lane 0's row takes expert capacity they needed; on the no-drop copy
    it moves nothing."""
    moved = {}
    for drops in (True, False):
        cfg = _cfg(arch, drops)
        spec = api.make_spec(cfg, device="cpu")
        params = api.prepare_params(api.init_params(cfg, 0, "cpu"), cfg,
                                    spec)
        rng = np.random.default_rng(3)
        toks = torch.from_numpy(rng.integers(1, cfg.vocab, (4, 12)))
        true_len = torch.tensor([12, 9, 11, 7], dtype=torch.int32)
        logits, cache = api.prefill(params, toks, cfg, spec, max_len=32,
                                    true_len=true_len)
        tok = logits.argmax(-1)[:, None]
        other = tok.clone()
        other[0, 0] = 4
        outs = [api.decode_step(params, {k: v.clone()
                                         for k, v in cache.items()},
                                t, cfg, spec)[0][1:, -1]
                for t in (tok, other)]
        moved[drops] = (outs[0] - outs[1]).abs().max().item()
    assert moved[True] > 0.1 and moved[False] == 0.0, moved


def test_idle_lanes_are_quiet_before_each_decode_step():
    """MoE configs: once a request leaves, its lane decodes token 0 at
    length 0; a dense config's idle lane is left as it was."""
    for arch, quiet in (("grok-1-314b", True), ("tinyllama-1.1b", False)):
        cfg = configs.reduced(configs.get_config(arch), mult="trunc2x2")
        eng = Engine(cfg, api.init_params(cfg, 0, "cpu"), capacity=2,
                     max_len=32, device="cpu")
        eng.submit(Request("a", E.prompt(5, 1, cfg.vocab),
                           SamplingParams(max_new_tokens=2)))
        eng.submit(Request("b", E.prompt(6, 2, cfg.vocab),
                           SamplingParams(max_new_tokens=6)))
        while len(eng.completions) < 1:
            eng.step()
        idle = next(i for i, s in enumerate(eng._slots) if s is None)
        before = (int(eng._tok[idle, 0]),
                  int(eng._arena.cache["length"][idle]))
        assert before != (0, 0)
        eng._quiet_idle_lanes(eng._decode_lanes())
        after = (int(eng._tok[idle, 0]),
                 int(eng._arena.cache["length"][idle]))
        assert after == ((0, 0) if quiet else before), arch
        done = {c.request_id: c.tokens for c in eng.run_until_complete()}
        assert len(done["b"]) == 6 and np.all(np.array(done["b"]) >= 0)


@pytest.mark.parametrize("case", ["S"] + sorted(E.PAGED_CASES))
def test_idle_mask_is_every_lane_but_the_decode_lanes(case):
    """The idle mask the engines keep on the device (set as a lane joins
    decode and as it leaves) equals, before every decode or spec step, the
    lanes that do not decode: free lanes, and a paged engine's prefilling
    ones."""
    cfg = _cfg("grok-1-314b")
    params = api.init_params(cfg, 0, "cpu")
    kw = dict(capacity=3, max_len=64, device="cpu")
    eng = (Engine(cfg, params, **kw) if case == "S"
           else PagedEngine(cfg, params, **kw, **E.PAGED_CASES[case]))
    seen = []
    quiet = eng._quiet_idle_lanes

    def check(lanes):
        want = [i not in lanes for i in range(eng.capacity)]
        assert eng._idle.tolist() == want, (lanes, eng._idle)
        seen.append(sum(want))
        quiet(lanes)

    eng._quiet_idle_lanes = check
    done = E.serve(eng, E.mixed_trace(cfg.vocab))
    assert len(done) == 8 and len(seen) > 0 and max(seen) > 0
    assert eng._idle.all()
