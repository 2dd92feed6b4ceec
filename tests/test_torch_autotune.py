"""The port's GEMM autotuner (`repro_torch.kernels.autotune`) and the
dispatch that reads it, on the CPU.

Measurement is a seeded deterministic stub everywhere (the tuner's
contract: measure(path, m, k, n, cand) -> seconds); the card is stood in
by its name and SM count.  The shape buckets and the election are held to
the JAX package's autotuner; the rest mirrors that package's tests, with
the port's divergences pinned: the plain path is never elected for a
CUDA key, entries are keyed on the card, plans carry `splits` where the
JAX package's carried `unroll`, and dispatch memoizes plans per process.
"""

import json
import os

import pytest
import torch

from repro.kernels import autotune as jautotune
from repro.kernels import dispatch as jdispatch
from repro_torch import device as D
from repro_torch.approx import gemm as G
from repro_torch.core import calibrate as cal
from repro_torch.kernels import approx_qgemm as qk
from repro_torch.kernels import autotune, dispatch, ops, qgemm

CARD = autotune.Card("NVIDIA H100 80GB HBM3", 132)


@pytest.fixture
def card(monkeypatch):
    """A CUDA device with the card's name and SM count (no card here)."""
    monkeypatch.setattr(D, "_props", lambda index: (CARD.name, CARD.sm_count))
    return torch.device("cuda", 0)


@pytest.fixture
def cache_path(tmp_path, monkeypatch):
    p = str(tmp_path / "TUNING_gemm_torch.json")
    monkeypatch.setenv("REPRO_TUNING_CACHE", p)
    monkeypatch.delenv("REPRO_KERNEL_POLICY", raising=False)
    autotune._MEMO.clear()
    yield p
    autotune._MEMO.clear()


def _stub(winner="fused", best=None):
    """measure(path, m, k, n, cand) -> seconds: `winner` 1 s, the others
    10 / 20 / 30 s; among the fused candidates `best` (a label) is 0.5 s
    faster than the rest, the rest tie."""
    def measure(path, m, k, n, cand):
        base = {"fused": 10.0, "stacked": 20.0, "xla": 30.0}
        t = 1.0 if path == winner else base[path]
        if path == "fused" and cand.label != best:
            t += 0.5
        return t
    return measure


def _tune(m, k, n, mode="trunc", rank=0, **kw):
    kw.setdefault("measure", _stub())
    return autotune.tune_gemm(m, k, n, mode=mode, rank=rank, card=CARD, **kw)


# --- held to the JAX package's autotuner --------------------------------------

SIZES = [1, 2, 3, 4, 5, 8, 16, 31, 32, 33, 64, 100, 128, 512, 1000, 1024,
         4096, 8192, 8193, 100352, 401408]
KN = [1, 27, 256, 576, 2048, 5632, 8192, 9000, 32000, 202048]


def test_shape_bucket_equals_the_jax_package():
    for m in SIZES:
        for k in KN:
            for n in KN:
                assert autotune.shape_bucket(m, k, n) == \
                    jautotune.shape_bucket(m, k, n), (m, k, n)


@pytest.mark.parametrize("us", [
    {"fused": 5.0, "stacked": 4.0}, {"fused": 4.0, "stacked": 5.0},
    {"fused": 4.0, "stacked": 4.0}, {"stacked": 3.0}, {"fused": 7.5}])
def test_record_winner_elects_as_the_jax_package(us, tmp_path):
    """On the kernel paths' medians both packages elect the same path (a
    tie goes to fused, the first of PATHS)."""
    got = autotune.record_winner(256, 512, 256, "exact", 0, us, card=CARD,
                                 path=str(tmp_path / "port.json"))
    want = jautotune.record_winner(
        256, 512, 256, "exact", 0, us, backend="cpu",
        vmem_budget=jdispatch.VMEM_BUDGET_BYTES,
        path=str(tmp_path / "jax.json"))
    assert got.path == want.path
    assert autotune.lookup(256, 512, 256, "exact", 0, device_key=CARD.key,
                           path=str(tmp_path / "port.json")).us == us


def test_a_plain_winner_never_vetoes_the_kernels(cache_path, card):
    """The JAX package elects XLA where it measures fastest; on a CUDA
    key the plain path is recorded as the yardstick and never elected."""
    us = {"fused": 10.0, "stacked": 9.0, "xla": 1.0}
    plan = autotune.record_winner(512, 512, 512, "exact", 0, us, card=CARD)
    assert plan.path == "stacked" and plan.us["xla"] == 1.0
    assert jautotune.record_winner(
        512, 512, 512, "exact", 0, us, backend="cpu",
        vmem_budget=jdispatch.VMEM_BUDGET_BYTES,
        path=cache_path + ".jax").path == "xla"
    got = dispatch.choose_gemm_path("auto", m=512, k=512, n=512,
                                    device=card, mode="exact")
    assert got.path == "stacked" and got.source == "tuned"
    tuned = _tune(256, 512, 256, measure=_stub("xla"))
    assert tuned.path == "fused" and tuned.us["xla"] == pytest.approx(1e6)
    with pytest.raises(ValueError, match="no kernel path"):
        autotune.record_winner(8, 8, 8, "exact", 0, {"xla": 1.0}, card=CARD)


# --- mirrors of the JAX package's tests, on the port's stub ------------------

def test_cache_round_trip(cache_path):
    plan = _tune(256, 512, 256, mode="lowrank", rank=2)
    assert plan.path == "fused" and os.path.exists(cache_path)
    hit = autotune.lookup(256, 512, 256, "lowrank", 2, device_key=CARD.key)
    assert hit is not None and hit.as_dict() == plan.as_dict()
    assert hit.source == "measured" and hit.label == plan.label
    # same shape bucket: a nearby shape hits the same entry
    assert autotune.lookup(250, 500, 250, "lowrank", 2,
                           device_key=CARD.key) is not None
    # another mode, rank or card misses
    other = autotune.Card("NVIDIA H100 PCIe", 114)
    for args, key in (((256, 512, 256, "exact", 0), CARD.key),
                      ((256, 512, 256, "lowrank", 4), CARD.key),
                      ((256, 512, 256, "lowrank", 2), other.key),
                      ((256, 512, 256, "lowrank", 2),
                       autotune.Card(CARD.name, 114).key)):
        assert autotune.lookup(*args, device_key=key) is None
    raw = json.load(open(cache_path))
    assert raw["package"] == "repro_torch"
    assert raw["kernel_version"] == autotune.kernel_version()
    assert list(raw["entries"]) == [
        f"{CARD.name}|sm132|m256_k512_n256|lowrank|r2"]


def test_deterministic_winner(cache_path):
    static = autotune.static_candidate(128, 2048, 2048, 1, sm_count=132)
    best = "plane0/s2"
    assert best != static.label
    plans = [_tune(128, 2048, 2048, measure=_stub("fused", best))
             for _ in range(3)]
    assert len({json.dumps(p.as_dict(), sort_keys=True) for p in plans}) == 1
    assert plans[0].label == best and plans[0].splits == 2
    assert plans[0].static == static.label
    assert plans[0].candidates[static.label] == pytest.approx(1.5e6)
    # a stub under which the stacked kernel is fastest elects it
    plan = _tune(256, 512, 256, mode="lowrank", rank=2,
                 measure=_stub("stacked"))
    assert plan.path == "stacked" and plan.bn in autotune.BN_CANDIDATES


def test_stale_entries_read_as_empty(cache_path):
    _tune(128, 2048, 2048)

    def reload():
        autotune._MEMO.clear()
        return autotune.lookup(128, 2048, 2048, "trunc", 0,
                               device_key=CARD.key)

    assert reload() is not None
    raw = json.load(open(cache_path))
    for field, stale in (("kernel_version", "0" * 16),
                         ("schema", autotune.CACHE_SCHEMA + 1),
                         ("package", "repro")):
        bad = dict(raw, **{field: stale})
        json.dump(bad, open(cache_path, "w"))
        assert reload() is None, field
    # a file the JAX package wrote (its integer kernel version, no package
    # stamp) is stale too, even where its key would match
    jautotune.put(jautotune.TunedPlan("fused", 128, 128, 128), 128, 2048,
                  2048, "trunc", 0, backend=CARD.key,
                  vmem_budget=jdispatch.VMEM_BUDGET_BYTES, path=cache_path)
    assert reload() is None
    # and another card's key never hits
    json.dump(raw, open(cache_path, "w"))
    assert reload() is not None
    autotune._MEMO.clear()
    assert autotune.lookup(128, 2048, 2048, "trunc", 0,
                           device_key="NVIDIA H100 PCIe|sm114") is None


def test_corrupt_cache_falls_back(cache_path, card):
    with open(cache_path, "w") as f:
        f.write("{ this is not json")
    assert autotune.load_cache(cache_path)["entries"] == {}
    assert autotune.lookup(128, 2048, 2048, "trunc", 0,
                           device_key=CARD.key) is None
    plan = dispatch.choose_gemm_path("auto", m=128, k=2048, n=2048,
                                     device=card, mode="trunc")
    assert plan.source == "default" and plan.splits is None
    # a tuner run replaces the corrupt file with a valid one
    _tune(128, 2048, 2048)
    cache = autotune.load_cache(cache_path)
    assert cache["schema"] == autotune.CACHE_SCHEMA
    assert len(cache["entries"]) == 1


@pytest.mark.parametrize("mkn,planes", [
    ((4, 2048, 2048), 1), ((4, 2048, 256), 1), ((8, 25088, 4096), 6),
    ((128, 2048, 2048), 1), ((128, 5632, 2048), 1), ((512, 2048, 256), 1),
    ((401408, 576, 64), 6), ((1568, 4608, 512), 6), ((300, 27, 130), 3)])
def test_candidate_plans_cover_the_space(mkn, planes):
    """Every knob the kernel takes for the shape is timed, once, the
    static plan first: the skinny kernel's and plane 0's split counts
    1, 2, 4, ... (plane 0's as the whole K tiles they map to), the
    low-rank kernels' two tile widths."""
    m, k, n = mkn
    cands = autotune.candidate_plans(m, k, n, planes, sm_count=132)
    static = autotune.static_candidate(m, k, n, planes, sm_count=132)
    assert cands[0] == static and len(set(cands)) == len(cands)
    for c in cands:
        assert c.path == "fused" and c.skinny == (m <= qk.SKINNY_MAX_M)
        if c.skinny:
            qgemm.skinny_gran(-(-k // 16) * 16, c.splits)
        elif planes == 1:
            assert qgemm.plane0_split_plan(k, c.splits)[0] == c.splits
        else:
            assert c.splits is None and c.bn in autotune.BN_CANDIDATES
    if m <= qk.SKINNY_MAX_M:
        boxes = -(-k // 16) * 16 // qk.SKINNY_BOX
        want = {1 << i for i in range(boxes.bit_length())}
    elif planes == 1:
        tiles = -(-k // 64)
        want = {qgemm.plane0_split_plan(k, 1 << i)[0]
                for i in range(tiles.bit_length())}
    else:
        assert {c.bn for c in cands} == set(autotune.BN_CANDIDATES)
        return
    assert {c.splits for c in cands} == want | {static.splits}


#: Long-M GEMMs against a weight past half the card's L2 (LM heads at
#: training's row counts, a low-rank head, VGG16's first conv at rank 5):
#: where a roofline step like the JAX package's, fitted to the card, can
#: predict the stacked kernel.
FLIPPED = [(1024, 2048, 32000, 0), (4096, 2048, 32000, 0),
           (8192, 2048, 32000, 0), (4096, 4096, 128256, 0),
           (4096, 2048, 32000, 5), (401408, 576, 64, 5)]


@pytest.mark.parametrize("m,k,n,rank", FLIPPED)
def test_only_a_measurement_moves_a_gemm_off_the_static_plan(
        m, k, n, rank, cache_path, card):
    """Untuned "auto" on the card takes the static plan, "pallas"'s own,
    with no model step between: only a tuned entry can choose stacked."""
    mode = "lowrank" if rank else "trunc"
    kw = dict(m=m, k=k, n=n, device=card, mode=mode, rank=rank)
    plan = dispatch.choose_gemm_path("auto", **kw)
    assert plan.source == "default" and _key(plan) == _today(m, k, n, rank)
    assert _key(dispatch.choose_gemm_path("pallas", **kw)) == _key(plan)
    autotune.record_winner(m, k, n, mode, rank,
                           {"fused": 2.0, "stacked": 1.0}, card=CARD)
    plan = dispatch.choose_gemm_path("auto", **kw)
    assert (plan.path, plan.source) == ("stacked", "tuned")


def test_the_static_candidate_is_the_wrappers_own_choice():
    assert autotune.static_candidate(4, 2048, 256, 1, sm_count=132) == \
        autotune.Candidate("fused", 64, qgemm.skinny_splits(
            2048, 256, sm_count=132)[0], skinny=True)
    assert autotune.static_candidate(100, 2000, 300, 1, sm_count=132) == \
        autotune.Candidate("fused", 64, qgemm.plane0_splits(
            128, 2048, 320, sm_count=132)[0])
    assert autotune.static_candidate(300, 27, 192, 6, sm_count=132).bn == 64
    assert autotune.static_candidate(300, 27, 256, 6, sm_count=132).bn == 128
    # the card's SM count moves the split: 64 blocks fill more than half
    # of an H100 PCIe's 114 SMs, so K stays whole there
    assert qgemm.plane0_splits(128, 2048, 2048, sm_count=114)[0] == 1
    assert qgemm.plane0_splits(128, 2048, 2048, sm_count=132)[0] == 3
    assert qgemm.skinny_splits(2048, 2048, sm_count=114)[0] == 4
    assert qgemm.skinny_splits(2048, 2048, sm_count=132)[0] == 5


def test_dispatch_consults_cache(cache_path, card):
    # no cache: the static plan
    plan = dispatch.choose_gemm_path("auto", m=128, k=2048, n=2048,
                                     device=card, mode="trunc")
    assert (plan.path, plan.splits, plan.source) == ("fused", None,
                                                     "default")
    # a measured fused winner: auto and pallas return it, splits included
    _tune(128, 2048, 2048, measure=_stub("fused", "plane0/s2"))
    for policy in ("auto", "pallas"):
        plan = dispatch.choose_gemm_path(policy, m=128, k=2048, n=2048,
                                         device=card, mode="trunc")
        assert (plan.path, plan.splits, plan.source) == ("fused", 2, "tuned")
    # a measured stacked winner: auto returns it, pallas keeps its kernel
    _tune(256, 512, 256, mode="lowrank", rank=2, measure=_stub("stacked"))
    kw = dict(m=256, k=512, n=256, device=card, mode="lowrank", rank=2)
    assert dispatch.choose_gemm_path("auto", **kw).path == "stacked"
    plan = dispatch.choose_gemm_path("pallas", **kw)
    assert (plan.path, plan.source) == ("fused", "policy")
    # "xla" and CPU tensors behave as before
    assert dispatch.choose_gemm_path("xla", **kw).source == "policy"
    assert dispatch.choose_gemm_path(
        "auto", m=256, k=512, n=256, device="cpu", mode="lowrank",
        rank=2).path == "xla"


def test_tuned_entry_revalidated_against_the_shape(cache_path, card):
    """An entry whose knobs this shape cannot take is ignored: plane 0
    tuned at K = 2048 (32 tiles) to 32 splits, asked at K = 1100 of the
    same bucket (18 tiles); a tile width the kernels lack; a skinny entry
    where the shape is not decode-shaped."""
    def put(plan, m, k, n):
        autotune.put(plan, m, k, n, "trunc", 0, device_key=CARD.key)

    put(autotune.TunedPlan("fused", 64, splits=32), 128, 2048, 2048)
    kw = dict(device=card, mode="trunc")
    assert dispatch.choose_gemm_path("auto", m=128, k=2048, n=2048,
                                     **kw).splits == 32
    plan = dispatch.choose_gemm_path("auto", m=128, k=1100, n=2048, **kw)
    assert plan.source == "default" and plan.splits is None
    put(autotune.TunedPlan("stacked", 96), 256, 512, 256)
    assert dispatch.choose_gemm_path("auto", m=256, k=512, n=256,
                                     **kw).source == "default"
    put(autotune.TunedPlan("fused", 64, splits=2, skinny=True),
        64, 512, 256)
    assert dispatch.choose_gemm_path("auto", m=64, k=512, n=256,
                                     **kw).source == "default"
    put(autotune.TunedPlan("fused", 64, splits=None, skinny=True),
        4, 512, 256)
    assert dispatch.choose_gemm_path("auto", m=4, k=512, n=256,
                                     **kw).source == "default"


def test_shape_bucket_separates_decode_sizes():
    assert autotune.shape_bucket(1, 512, 256) != \
        autotune.shape_bucket(32, 512, 256)
    assert autotune.shape_bucket(250, 512, 256) == \
        autotune.shape_bucket(256, 512, 256)


# --- dispatch: plans memoized, today's plans without a cache -----------------

def test_plans_are_memoized_until_the_cache_changes(cache_path, card,
                                                    monkeypatch):
    kw = dict(m=128, k=2048, n=2048, device=card, mode="trunc")
    first = dispatch.choose_gemm_path("auto", **kw)
    assert dispatch.choose_gemm_path("auto", **kw) is first
    _tune(128, 2048, 2048, measure=_stub("fused", "plane0/s4"))
    tuned = dispatch.choose_gemm_path("auto", **kw)
    assert tuned.source == "tuned" and tuned.splits == 4
    assert dispatch.choose_gemm_path("auto", **kw) is tuned
    monkeypatch.setenv("REPRO_TUNING_CACHE", cache_path + ".other")
    assert dispatch.choose_gemm_path("auto", **kw).source == "default"


#: The approximate GEMMs chip_smoke.py runs, as (k, n): every model's
#: layers and LM heads (`model_gemm_shapes` of TinyLlama-1.1B, the
#: recurrent, conditioned and MoE families) ...
MODEL_KN = [
    (1024, 1024), (1024, 4096), (1024, 4384), (1024, 50280), (1024, 51865),
    (2048, 256), (2048, 1024), (2048, 2048), (2048, 5632), (2048, 32000),
    (4096, 256), (4096, 1024), (4096, 4096), (4096, 12288), (4096, 14336),
    (4096, 128256), (4096, 256000), (4608, 512), (4608, 4608),
    (4608, 18432), (4608, 49152), (5120, 1024), (5120, 5120), (5120, 8192),
    (5120, 16384), (5120, 202048), (5632, 2048), (6144, 1024),
    (6144, 6144), (6144, 32768), (6144, 131072), (8192, 5120),
    (12288, 4096), (14336, 4096), (16384, 5120), (18432, 4608),
    (32768, 6144)]
#: ... at the row counts `gemm_rows` gives them (decode at capacity 1-8,
#: first chunks, expert capacities, prefills, the 2-layer checks,
#: training, Whisper's 1500 frames, one image's 1600 tokens) ...
MODEL_M = [1, 2, 4, 5, 8, 32, 40, 128, 512, 1024, 1500, 1600]
#: ... the vision model's image K/V for 4 requests at once (M = 6400) ...
LARGE = [(6400, 4096, 1024)]
#: ... and VGG16's conv GEMMs (`vgg16_convs`, batch 8) and FC GEMMs.
VGG16 = [(401408, 27, 64), (401408, 576, 64), (100352, 576, 128),
         (100352, 1152, 128), (25088, 1152, 256), (25088, 2304, 256),
         (6272, 2304, 512), (6272, 4608, 512), (1568, 4608, 512),
         (8, 25088, 4096), (8, 4096, 4096), (8, 4096, 1000)]


def _today(m, k, n, rank):
    """The plan the port's dispatch returned before the tuning cache."""
    if m <= qk.SKINNY_MAX_M:
        sbk, sbn = qk.choose_skinny_blocks(k, n)
        return ("fused", m, sbk, sbn, True, None)
    return ("fused", *qk.choose_blocks(m, k, n,
                                       kernel="fused" if rank else "plane0"),
            False, None)


def _key(plan):
    return (plan.path, plan.bm, plan.bk, plan.bn, plan.skinny, plan.splits)


def test_no_cache_keeps_todays_plan_on_every_smoke_shape(cache_path, card):
    """With no cache every shape chip_smoke.py runs gets today's plan,
    the static one, under "pallas" (its model phases' policy) and "auto"
    (its autotune and co-design phases')."""
    shapes = [(m, k, n) for m in MODEL_M for k, n in MODEL_KN] + LARGE
    shapes = [(m, k, n, 0) for m, k, n in shapes] + \
        [(m, k, n, rank) for m, k, n in VGG16 for rank in (0, 5)]
    for m, k, n, rank in shapes:
        mode = "lowrank" if rank else "trunc"
        for policy, source in (("pallas", "policy"), ("auto", "default")):
            plan = dispatch.choose_gemm_path(policy, m=m, k=k, n=n,
                                             device=card, mode=mode,
                                             rank=rank)
            assert _key(plan) == _today(m, k, n, rank) and \
                plan.source == source, (policy, m, k, n, rank)


# --- the plan's knobs reach the kernels ---------------------------------------

class _FakeLib:
    """Records each entry point's arguments (the kernels cannot run here)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


@pytest.fixture
def fake_lib(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(qgemm.build, "load", lambda: lib)
    monkeypatch.setattr(qgemm.build, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(qgemm, "_check_cuda", lambda name, *ts: None)
    monkeypatch.setattr(qgemm, "device_sm_count", lambda device: 132)
    monkeypatch.setattr(qgemm, "_skinny_state", {})
    return lib


def _meta(*shape):
    return torch.empty(shape, dtype=torch.int8, device="meta")


def test_wrappers_pass_the_plans_knobs_to_the_kernels(fake_lib):
    """On tensors that are not on the CPU the wrappers launch: the split
    count becomes plane 0's k_chunk (whole K tiles) and skinny's splits
    and unit, the tile width reaches the fused and stacked kernels; None
    keeps each wrapper's own choice."""
    a, bt = _meta(128, 2048), _meta(2048, 2048)
    qgemm.approx_qgemm_plane0(a, bt, splits=2)
    qgemm.approx_qgemm_plane0(a, bt)
    (_, got), (_, static) = fake_lib.calls[-2:]
    assert got[-2] == 1024 and static[-2] == 704          # k_chunk
    a, bt = _meta(4, 2048), _meta(2048, 2048)
    none = _meta(0, 256)
    for splits in (4, 32, None):
        qgemm.approx_qgemm_skinny(a, bt, none, none, k_valid=2048,
                                  splits=splits)
    got = [c[1][-3:-1] for c in fake_lib.calls[-3:]]
    assert got == [(4, 128), (32, 32), (5, 128)]          # (splits, gran)
    fu = torch.zeros((5, 256), dtype=torch.int8, device="meta")
    scales = torch.ones(6, device="meta")
    a, bt = _meta(256, 576), _meta(128, 576)
    for bn in (64, 128, None):
        qgemm.approx_qgemm_fused(a, bt, fu, fu, scales, k_valid=576, bn=bn)
    assert [c[1][10] for c in fake_lib.calls[-3:]] == [64, 128, 128]
    a_s, b_s = _meta(6, 256, 576), _meta(6, 576, 128)
    for bn in (64, None):
        qgemm.approx_qgemm_stacked(a_s, b_s, scales, bn=bn)
    assert [c[1][-2] for c in fake_lib.calls[-2:]] == [64, 128]


def test_a_knob_the_shape_cannot_take_raises():
    a, bt = torch.zeros((64, 128), dtype=torch.int8), \
        torch.zeros((64, 128), dtype=torch.int8)
    with pytest.raises(ValueError, match="K splits of 2 K tiles"):
        qgemm.approx_qgemm_plane0(a, bt, splits=3)
    none = torch.zeros((0, 256), dtype=torch.int8)
    with pytest.raises(ValueError, match="K splits"):
        qgemm.approx_qgemm_skinny(a[:4], bt, none, none, k_valid=128,
                                  splits=5)
    fu = torch.zeros((1, 256), dtype=torch.int8)
    for bn in (32, 96, 128):
        with pytest.raises(ValueError, match="tile width"):
            qgemm.approx_qgemm_fused(a, bt, fu, fu, torch.ones(2),
                                     k_valid=128, bn=bn)
    with pytest.raises(ValueError, match="tile width"):
        qgemm.approx_qgemm_stacked(a[None], bt.T[None], torch.ones(1),
                                   bn=128)


@pytest.mark.parametrize("k", [64, 640, 2048, 5632])
def test_plane0_split_plan_asks_for_itself_again(k):
    """A split count the plan returns maps back to the same k_chunk, so a
    tuned entry runs the split it measured; the static plan is one."""
    tiles = k // 64
    for want in range(1, tiles + 1):
        got, chunk = qgemm.plane0_split_plan(k, want)
        assert got >= want and chunk % 64 == 0
        assert qgemm.plane0_split_plan(k, got) == (got, chunk)
    for shape in [(128, k, 2048), (128, k, 256), (4096, k, 2048)]:
        splits, chunk = qgemm.plane0_splits(*shape, sm_count=132)
        assert qgemm.plane0_split_plan(k, splits) == (splits, chunk)


def test_ops_passes_the_plan_through(monkeypatch):
    seen = []

    def spy(name):
        real = getattr(qgemm, name)

        def wrapper(*args, **kw):
            seen.append((name, kw.get("splits"), kw.get("bn")))
            return real(*args, **kw)
        monkeypatch.setattr(qgemm, name, wrapper)

    for name in ("approx_qgemm_plane0", "approx_qgemm_skinny",
                 "approx_qgemm_fused", "approx_qgemm_stacked"):
        spy(name)
    trunc = G.spec_from_name("trunc2x2")
    gen = torch.Generator().manual_seed(0)

    def q(*shape):
        return torch.randint(-128, 128, shape, generator=gen,
                             dtype=torch.int8)

    a, b = q(100, 200), q(200, 96)
    want = G.approx_qgemm(a, b, trunc)
    plans = [dispatch.GemmPlan("fused", 64, 64, 64, splits=2),
             dispatch.GemmPlan("stacked", 128, 32, 64)]
    for plan in plans:
        assert torch.equal(ops.approx_qgemm_planned(a, b, trunc, plan), want)
    plan = dispatch.GemmPlan("fused", 4, 16, 1, skinny=True, splits=2)
    assert torch.equal(ops.approx_qgemm_planned(a[:4], b, trunc, plan),
                       want[:4])
    lowrank = G.spec_from_name("pareto:0.01")
    plan = dispatch.GemmPlan("fused", 128, 32, 128)
    assert torch.equal(ops.approx_qgemm_planned(a, b, lowrank, plan),
                       G.approx_qgemm(a, b, lowrank))
    assert seen == [("approx_qgemm_plane0", 2, None),
                    ("approx_qgemm_stacked", None, 64),
                    ("approx_qgemm_skinny", 2, None),
                    ("approx_qgemm_fused", None, 128)]


# --- nothing to measure on the CPU; the anchor records its plan's source ------

def test_tune_gemm_on_the_cpu_raises(cache_path):
    spec = G.spec_from_name("trunc2x2")
    with pytest.raises(ValueError, match="CUDA device"):
        autotune.tune_gemm(128, 256, 128, spec, device="cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        autotune.measure_real(spec, "cpu")
    with pytest.raises(ValueError, match="card"):
        autotune.tune_gemm(128, 256, 128, mode="trunc", rank=0,
                           measure=_stub())
    assert not os.path.exists(cache_path)


def test_the_tuner_times_what_its_contract_says(cache_path):
    calls = []

    def measure(path, m, k, n, cand):
        calls.append((path, cand))
        return 1.0

    plan = _tune(4, 2048, 2048, measure=measure)
    paths = [p for p, _ in calls]
    assert paths.count("xla") == 1 and calls[-1] == ("xla", None)
    assert paths.count("stacked") == len(autotune.BN_CANDIDATES)
    fused = [c for p, c in calls if p == "fused"]
    assert fused == autotune.candidate_plans(4, 2048, 2048, 1,
                                             sm_count=132)
    assert fused[0] == autotune.static_candidate(4, 2048, 2048, 1,
                                                 sm_count=132)
    assert plan.label == fused[0].label        # ties: the static plan
    assert set(plan.candidates) == {c.label for _, c in calls if c}


def test_calibrate_gemm_records_its_plans_source():
    c = cal.calibrate_gemm(m=8, k=16, n=8, reps=1, device="cpu")
    assert c.meta["dispatch"]["source"] == "default"
    assert c.meta["dispatch"]["path"] == "xla"
    c = cal.calibrate_gemm(m=8, k=16, n=8, reps=1, device="cpu",
                           policy="pallas")
    assert c.meta["dispatch"]["source"] == "policy"
    assert c.meta["dispatch"]["splits"] is None
