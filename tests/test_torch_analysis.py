"""repro_torch.analysis: the findings model (held to the JAX package's
suppression machinery), each of the four checkers proven live by a seeded
violation and clean on this repository, the engines' launch budgets held
to what the kernels' wrappers are called for at a reduced size, the CLI,
the baseline and the docs.  CPU only: the cases that need the card (the
library query against the Python model, the host syncs and launches of
a step) are `cuda`-marked in tests/test_torch_analysis_cuda.py, which
imports no JAX."""

import json
import os
import re
import textwrap

import numpy as np
import pytest
import torch

from repro.analysis import findings as jfindings
from repro_torch.analysis import findings as fmod
from repro_torch.analysis.findings import (
    Baseline, Finding, apply_suppressions)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def retrace_sanitizer():
    """A RetraceSanitizer (host syncs off: CPU) that asserts every budget
    at teardown."""
    from repro_torch.analysis.retrace import RetraceSanitizer
    s = RetraceSanitizer(syncs=False)
    yield s
    s.assert_ok()


# --------------------------------------------------------------------------
# findings / suppressions
# --------------------------------------------------------------------------

def test_finding_checker_derived_from_code():
    assert Finding("JH101", "a.py", "m").checker == "jit"
    assert Finding("RT201", "x", "m").checker == "retrace"
    assert Finding("SC301", "x", "m").checker == "sharding"
    assert Finding("PC401", "x", "m").checker == "kernels"
    for code in ("ZZ999", "JH104"):     # JH104 has no counterpart here
        with pytest.raises(AssertionError):
            Finding(code, "x", "m")


def test_inline_allow_comment():
    assert fmod.inline_allowed("x = 1  # analysis: allow[JH102] why") \
        == "JH102"
    assert fmod.inline_allowed("x = 1  # plain comment") is None


def test_baseline_match_and_stale_tracking():
    b = Baseline([{"code": "SC301", "path": "sharding/rules:lm",
                   "reason": "known"},
                  {"code": "JH101", "path": "never/hit.py",
                   "reason": "stale"}])
    assert b.match(Finding("SC301", "sharding/rules:lm", "m")) == "known"
    assert [e["path"] for e in b.unused()] == ["never/hit.py"]
    with pytest.raises(ValueError):
        Baseline([{"code": "XX000", "path": "p", "reason": "r"}])
    with pytest.raises(ValueError):
        Baseline([{"code": "JH101"}])


def test_apply_suppressions_inline(tmp_path):
    (tmp_path / "mod.py").write_text(
        "x = 1\ny = 2  # analysis: allow[JH103] vetted\n")
    fs = [Finding("JH103", "mod.py", "m", line=2),
          Finding("JH103", "mod.py", "m", line=1)]
    apply_suppressions(fs, Baseline([]), str(tmp_path))
    assert fs[0].suppressed and fs[0].suppress_reason == "inline allow"
    assert not fs[1].suppressed


_SUPPRESSION_CASES = {
    "inline": ([("JH101", "mod.py", 2), ("JH101", "mod.py", 1),
                ("JH102", "mod.py", 2)], []),
    "baseline": ([("SC301", "sharding/rules:lm", 0),
                  ("PC405", "kernels/autotune:put", 0),
                  ("RT202", "serving/engine:decode", 0)],
                 [{"code": "SC301", "path": "sharding/rules:lm",
                   "reason": "known"},
                  {"code": "RT201", "path": "never", "reason": "stale"}]),
    "both": ([("JH103", "mod.py", 3), ("JH103", "mod.py", 2),
              ("JH101", "other.py", 1)],
             [{"code": "JH103", "path": "mod.py", "reason": "file-wide"}]),
}


@pytest.mark.parametrize("case", sorted(_SUPPRESSION_CASES))
def test_apply_suppressions_matches_the_jax_package(case, tmp_path):
    """The same findings and baseline give the same suppressed set, reasons
    and stale entries in both packages."""
    (tmp_path / "mod.py").write_text(
        "x = 1\ny = 2  # analysis: allow[JH101] vetted\n"
        "z = 3  # analysis: allow[JH103] numpy on purpose\n")
    (tmp_path / "other.py").write_text("w = 4\n")
    items, entries = _SUPPRESSION_CASES[case]
    got, want = [], []
    for mod, out in ((fmod, got), (jfindings, want)):
        fs = [mod.Finding(c, p, "m", line=ln) for c, p, ln in items]
        b = mod.Baseline([dict(e) for e in entries])
        mod.apply_suppressions(fs, b, str(tmp_path))
        out.append([(f.suppressed, f.suppress_reason) for f in fs])
        out.append(b.unused())
    assert got == want


# --------------------------------------------------------------------------
# host-sync lint (JH)
# --------------------------------------------------------------------------

HAZARD_SRC = textwrap.dedent("""\
    import numpy as np
    import torch


    def step(x: torch.Tensor, n: int):
        if (x > 0).any():
            x = x + 1
        np.square(x)
        return helper(x) + n


    def helper(x: torch.Tensor):
        return float(x)


    def host_only(x: torch.Tensor):
        return x.item() + np.asarray(x).sum()
""")


def _tree(tmp_path, src, rel=("kernels", "ops.py")):
    """A package tree whose `src/repro_torch/<rel>` holds `src`: ops.py is
    a step root (every function), so its functions are reachable."""
    path = tmp_path.joinpath("src", "repro_torch", *rel)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(src)
    return tmp_path


@pytest.fixture
def hazard_tree(tmp_path):
    """HAZARD_SRC in the slot engine's module, reached from its root
    `Engine._decode`."""
    return _tree(tmp_path, HAZARD_SRC + textwrap.dedent("""\


        class Engine:
            def _decode(self, x: torch.Tensor):
                return step(x, 1)
    """), ("serving", "engine.py"))


def test_lint_seeded_violations_fire_exact_codes(hazard_tree):
    from repro_torch.analysis import lint
    fs = lint.check(str(hazard_tree))
    assert sorted(f.code for f in fs) == ["JH101", "JH102", "JH103"], \
        [f.render() for f in fs]
    # reachability: helper() is flagged only because a step calls it, and
    # host_only() is reached by nothing
    assert [f.code for f in fs if "helper" in f.message] == ["JH101"]
    assert not [f for f in fs if "host_only" in f.message]
    assert all(f.path == os.path.join("src", "repro_torch", "serving",
                                      "engine.py") and f.line > 0
               for f in fs)


#: (statement in a step, the code it fires or None)
_LINT_CASES = [
    ("y = x.item()", "JH101"),
    ("y = x.tolist()", "JH101"),
    ("y = x.cpu()", "JH101"),
    ("y = x.numpy()", "JH101"),
    ("y = int(x[0])", "JH101"),
    ("y = bool(x.sum() > 0)", "JH101"),
    ("y = np.asarray(x)", "JH101"),
    ("torch.cuda.synchronize()", "JH101"),
    ("y = torch.nonzero(x)", "JH101"),
    ("y = x.masked_select(x > 0)", "JH101"),
    ("y = torch.unique(x)", "JH101"),
    ("y = torch.where(x > 0)", "JH101"),
    ("y = x[x > 0]", "JH101"),
    ("m = torch.isnan(x)\n    y = x[m]", "JH101"),
    ("y = torch.from_numpy(a).to(x.device)", "JH101"),
    ("y = torch.tensor([1], device=x.device)", "JH101"),
    ("y = np.exp(x)", "JH103"),
    ("y = 1 if x.max() > 0 else 0", "JH102"),
    ("assert (x >= 0).all()", "JH102"),
    ("while x.sum() > 0:\n        x = x - 1", "JH102"),
    # none of these syncs
    ("y = torch.from_numpy(a).to(x.device, non_blocking=True)", None),
    ("y = torch.where(x > 0, x, 0)", None),
    ("y = x.shape[0] > 1 and x.ndim == 2", None),
    ("y = x if x is not None else x", None),
    ("y = torch.full((), 3, device=x.device)", None),
    ("y = x.masked_fill(x > 0, 0)", None),
    ("x = np.zeros(3)\n    y = float(x[0])", None),
]


@pytest.mark.parametrize("stmt,code", _LINT_CASES,
                         ids=[s.split("\n")[0] for s, _ in _LINT_CASES])
def test_lint_flags_each_host_sync(tmp_path, stmt, code):
    from repro_torch.analysis import lint
    src = ("import numpy as np\nimport torch\n\n\n"
           "def step(x: torch.Tensor, a: np.ndarray):\n"
           f"    {stmt}\n    return x\n")
    fs = lint.check(str(_tree(tmp_path, src)))
    assert [f.code for f in fs] == ([code] if code else []), \
        [f.render() for f in fs]


def test_lint_follows_base_classes_and_family_edges(tmp_path):
    """`self.method` resolves into a base class's module; `api.decode_step`
    reaches every family's decode_step."""
    from repro_torch.analysis import lint
    pkg = tmp_path / "src" / "repro_torch"
    (pkg / "serving").mkdir(parents=True)
    (pkg / "models").mkdir()
    (pkg / "serving" / "engine.py").write_text(textwrap.dedent("""\
        class Engine:
            def _emit(self, t):
                return t.item()
    """))
    (pkg / "serving" / "paged.py").write_text(textwrap.dedent("""\
        from repro_torch.models import api
        from repro_torch.serving.engine import Engine


        class PagedEngine(Engine):
            def _decode(self, t):
                api.decode_step(t)
                return self._emit(t)
    """))
    (pkg / "models" / "api.py").write_text(
        "def decode_step(t):\n    return t\n")
    (pkg / "models" / "mamba2.py").write_text(textwrap.dedent("""\
        import torch


        def decode_step(t: torch.Tensor):
            return t.cpu()
    """))
    fs = lint.check(str(tmp_path))
    assert sorted((os.path.basename(f.path), f.code) for f in fs) == [
        ("engine.py", "JH101"), ("mamba2.py", "JH101")]


def test_lint_roots_exist():
    """Every `STEP_ROOTS` entry names a function of this repo: a renamed
    step cannot drop out of the lint unnoticed."""
    from repro_torch.analysis import lint
    index = lint.build_index(REPO)
    for rel, qual in lint.STEP_ROOTS:
        assert rel in index, rel
        assert qual == "*" or qual in index[rel].functions, (rel, qual)


def test_lint_clean_on_this_repo():
    """Every finding is fixed or suppressed inline, with its reason."""
    from repro_torch.analysis import lint
    fs = apply_suppressions(lint.check(REPO), Baseline([]), REPO)
    assert [f.render() for f in fs if not f.suppressed] == []
    for f in fs:
        line = open(os.path.join(REPO, f.path)).read().splitlines()[
            f.line - 1]
        reason = line.split(f"allow[{f.code}]", 1)[1].strip()
        assert len(reason) > 10, (f.render(), line)
    # the deliberate syncs of a step: the tokens of a decode and of a
    # verify step, an admission's first token
    where = {(os.path.basename(f.path), f.message.split("`")[1])
             for f in fs}
    for want in (("engine.py", "Engine._decode"),
                 ("engine.py", "Engine._admit"),
                 ("paged.py", "PagedEngine._decode"),
                 ("paged.py", "PagedEngine._verify")):
        assert want in where, where


# --------------------------------------------------------------------------
# launch / build / one-time-work budgets (RT)
# --------------------------------------------------------------------------

class _Counter:
    """A stand-in kernel wrapper: counts its calls as launches."""

    def __init__(self):
        self.launches = 0

    def __call__(self):
        self.launches += 1


def test_retrace_over_budget_rt201(monkeypatch):
    from repro_torch.analysis.retrace import Budget, KERNELS, \
        RetraceSanitizer
    from repro_torch.kernels import qgemm
    fake = _Counter()
    monkeypatch.setattr(qgemm, "approx_qgemm_skinny", fake)
    s = RetraceSanitizer(syncs=False)
    want = dict.fromkeys(KERNELS, 0)
    want["approx_qgemm_skinny"] = 1
    w = s.watch("test:launch-storm", lambda: (fake(), fake()),
                Budget(launches=want))
    w()
    fs = s.findings()
    assert [f.code for f in fs] == ["RT201"]
    assert "'approx_qgemm_skinny': 2" in fs[0].message
    with pytest.raises(AssertionError):
        s.assert_ok()


def test_retrace_cold_repeat_rt202():
    """A repeat call with the same signature that resolves a new dispatch
    plan (its shape changed under a signature that claims it did not)."""
    from repro_torch.analysis.retrace import Budget, RetraceSanitizer
    from repro_torch.kernels import dispatch
    shapes = iter(range(1000, 1010))

    def step():
        dispatch.choose_gemm_path("pallas", m=4, k=next(shapes), n=64,
                                  device="cpu", mode="trunc")

    s = RetraceSanitizer(syncs=False)
    w = s.watch("test:cold", step, Budget())
    w()                                   # the first call may plan
    assert s.findings() == []
    w()
    fs = s.findings()
    assert [f.code for f in fs] == ["RT202"]
    assert "plan_misses" in fs[0].message


def test_retrace_within_budget_clean(retrace_sanitizer):
    from repro_torch.analysis.retrace import Budget
    from repro_torch.kernels import dispatch
    w = retrace_sanitizer.watch(
        "test:warm", lambda: dispatch.choose_gemm_path(
            "pallas", m=4, k=777, n=64, device="cpu", mode="trunc"),
        Budget(syncs=3))                  # syncs unchecked off the card
    for _ in range(3):
        w()
    rep = retrace_sanitizer.report()["test:warm"]
    assert rep["calls"] == 3
    assert rep["one_time_after_first"]["plan_misses"] == 0


def _cfg(**kw):
    from repro_torch import configs
    return configs.apply_overrides(configs.get_config(
        "tinyllama-1.1b", mult="trunc2x2", kernel_policy="pallas",
        attn_impl="flash", **kw), reduced=True)


def test_step_launches_match_the_decode_formula():
    """155 quantize_rows + 155 skinny per full-width TinyLlama decode step
    (22 layers x 7 GEMMs + the head), 22 flash per prefill."""
    from repro_torch import configs
    from repro_torch.analysis.retrace import step_launches
    cfg = configs.get_config("tinyllama-1.1b", mult="trunc2x2",
                             attn_impl="flash", dtype="float32")
    dec = step_launches(cfg, 4, 1, False)
    assert (dec["quantize_rows"], dec["approx_qgemm_skinny"]) == (155, 155)
    assert sum(dec.values()) == 310
    pre = step_launches(cfg, 1, 128, True)
    assert (pre["approx_qgemm_plane0"], pre["approx_qgemm_skinny"],
            pre["flash_attention"]) == (154, 1, 22)
    low = step_launches(cfg, 1, 128, True, lowrank=True)
    assert low["approx_qgemm_fused"] == 154 and \
        low["approx_qgemm_plane0"] == 0


def test_engine_budgets_slot_and_paged():
    from repro_torch.analysis.retrace import engine_budgets, step_launches
    from repro_torch.serving import Engine, PagedEngine
    cfg = _cfg()
    eng = Engine(cfg, capacity=2, max_len=48, device="cpu")
    off = engine_budgets(eng)
    assert set(off) == {"serving/engine:decode", "serving/engine:prefill"}
    assert sum(off["serving/engine:decode"].launches().values()) == 0
    assert off["serving/engine:decode"].syncs is None
    on = engine_budgets(eng, on_card=True)
    assert on["serving/engine:decode"].launches() == \
        step_launches(cfg, 2, 1, False)
    assert on["serving/engine:decode"].syncs == Engine.HOST_SYNCS["decode"]
    paged = PagedEngine(cfg, capacity=2, max_len=48, page_size=8,
                        prefill_chunk=8, draft_tier="trunc4x4", spec_k=3,
                        device="cpu")
    b = engine_budgets(paged, on_card=True)
    assert set(b) == {"serving/engine:decode", "serving/engine:prefill",
                      "serving/paged:first_chunk", "serving/paged:chunk",
                      "serving/paged:draft", "serving/paged:verify"}
    three = {k: 3 * v for k, v in step_launches(cfg, 2, 1, False).items()}
    assert b["serving/paged:draft"].launches() == three
    assert b["serving/paged:verify"].syncs == 1
    assert b["serving/paged:draft"].syncs == 0


def _shim(real):
    def shim(*args, **kwargs):
        shim.launches += 1
        return real(*args, **kwargs)
    shim.launches = 0
    return shim


def _counting_shims(monkeypatch):
    """Each kernel wrapper counts its calls as launches on the CPU, where
    the real ones run their plain versions and count none."""
    import importlib

    from repro_torch.analysis.retrace import KERNELS
    for mod, attr in KERNELS.values():
        m = importlib.import_module(f"repro_torch.kernels.{mod}")
        monkeypatch.setattr(m, attr, _shim(getattr(m, attr)))


_ENGINE_CASES = {
    "S": ("Engine", {}),
    "P": ("PagedEngine", dict(page_size=8)),
    "PC": ("PagedEngine", dict(page_size=8, prefill_chunk=8)),
    "PS": ("PagedEngine", dict(page_size=8, draft_tier="trunc4x4",
                               spec_k=3)),
}


@pytest.mark.parametrize("case", sorted(_ENGINE_CASES))
def test_engine_launch_budgets_hold(monkeypatch, case):
    """At a reduced size on the CPU, with every wrapper counting its calls,
    each watched step calls the kernels `engine_budgets` says it launches
    on the card, and no repeat step does one-time work."""
    from repro_torch import serving
    from repro_torch.analysis.retrace import instrument_engine
    from repro_torch.serving import Request, SamplingParams
    _counting_shims(monkeypatch)
    cls, kw = _ENGINE_CASES[case]
    eng = getattr(serving, cls)(_cfg(), capacity=2, max_len=64,
                                prefill_buckets=(16, 48), device="cpu",
                                **kw)
    s = instrument_engine(eng, on_card=True)
    rng = np.random.default_rng(3)
    for i, (n, temp) in enumerate([(9, 0.0), (20, 0.8), (30, 0.0)]):
        eng.submit(Request(f"r{i}", rng.integers(1, 512, n).tolist(),
                           SamplingParams(max_new_tokens=4, temperature=temp,
                                          top_k=8 if temp else 0, seed=i),
                           arrival=float(i)))
    eng.run_until_complete()
    assert s.findings() == [], [f.render() for f in s.findings()]
    rep = s.report()
    assert rep["serving/engine:prefill" if case != "PC" else
               "serving/paged:first_chunk"]["calls"] >= 1
    decode = "serving/paged:verify" if case == "PS" else \
        "serving/engine:decode"
    assert rep[decode]["calls"] >= 3
    assert rep[decode]["launches_per_call"] != [()]


#: The engines' tokens on a seeded trace before the stray host syncs left
#: their steps (H2D copies made non-blocking, scalar writes made device
#: fills, a verify step's three reads merged into one): held bit for bit.
GOLDEN_TOKENS = {
    "r0": [90, 90, 90, 90, 90], "r1": [465, 169, 230, 303, 77],
    "r2": [266, 157, 157, 379, 152], "r3": [467, 484, 92, 442, 157],
    "r4": [216, 92, 492, 196, 162]}


@pytest.mark.parametrize("case", sorted(_ENGINE_CASES))
def test_sync_removal_leaves_the_tokens(case):
    from repro_torch import configs, serving
    from repro_torch.serving import Request, SamplingParams
    cfg = configs.apply_overrides(configs.get_config(
        "tinyllama-1.1b", mult="trunc2x2", kernel_policy="pallas"),
        reduced=True)
    cls, kw = _ENGINE_CASES[case]
    kw = dict(kw, prefill_chunk=8, chunk_budget=1) if case == "PC" else kw
    eng = getattr(serving, cls)(cfg, capacity=2, max_len=64,
                                prefill_buckets=(16, 48), seed=0,
                                device="cpu", **kw)
    rng = np.random.default_rng(5)
    for i, (n, t, temp) in enumerate([(9, 0, 0.0), (20, 0, 0.8),
                                      (13, 1, 0.0), (30, 2, 1.1),
                                      (40, 3, 0.0)]):
        eng.submit(Request(f"r{i}", rng.integers(1, cfg.vocab, n).tolist(),
                           SamplingParams(max_new_tokens=5, temperature=temp,
                                          top_k=8 if temp else 0, seed=i),
                           arrival=float(t)))
    got = {c.request_id: c.tokens for c in eng.run_until_complete()}
    assert got == GOLDEN_TOKENS


def test_retrace_check_clean_on_cpu():
    from repro_torch.analysis import retrace
    assert [f.render() for f in retrace.check(device="cpu")] == []


# --------------------------------------------------------------------------
# sharding coverage (SC)
# --------------------------------------------------------------------------

def test_coverage_unknown_param_leaf_sc301():
    from repro_torch.analysis import coverage
    cfg = coverage.family_config("lm")
    fs = coverage._check_params(cfg, [("mystery_w", (128, 128)),
                                      ("ln1", (2, 64)), ("bias", (64,))])
    assert [f.code for f in fs] == ["SC301"]
    assert "mystery_w" in fs[0].message  # exempt ln1 not flagged


def test_coverage_unknown_cache_key_sc302():
    from repro_torch.analysis import coverage
    cfg = coverage.family_config("lm")
    fs = coverage._check_cache(cfg, {"weird_state": torch.empty(2, 4, 8),
                                     "k": torch.empty(2, 2, 8, 2, 4)})
    assert [f.code for f in fs] == ["SC302"]
    assert "weird_state" in fs[0].message


def test_coverage_unsharded_batch_sc303(monkeypatch):
    from repro_torch.analysis import coverage
    from repro_torch.launch.mesh import make_abstract_mesh
    from repro_torch.sharding import rules
    cfg = coverage.family_config("encdec")
    mesh = make_abstract_mesh((2, 2), ("data", "model"))
    assert coverage._check_batch(cfg, mesh) == []
    monkeypatch.setattr(rules, "batch_pspec", lambda *a: (None, None))
    fs = coverage._check_batch(cfg, mesh)
    assert {f.code for f in fs} == {"SC303"} and len(fs) == 4


def test_coverage_clean_on_all_families():
    from repro_torch.analysis import coverage
    assert [f.render() for f in coverage.check()] == []


@pytest.mark.parametrize("family", ["lm", "ssm", "hybrid", "encdec"])
def test_coverage_leaf_names_match_the_jax_package(family):
    """The port's walk resolves the same leaf names, each with the same
    shapes, as the JAX package's `_leaf_name` over `jax.eval_shape` of its
    `init_params` on the same reduced config.  The one listed exception is
    of the serving tree: the port's prepared weights carry a K-major copy
    (`wq_t`) the JAX package's do not, which resolves to its weight's name
    like every other `PreparedWeight` field."""
    import jax

    from repro import configs as jconfigs
    from repro.analysis import coverage as jcov
    from repro.models import api as japi
    from repro_torch.analysis import coverage
    from repro_torch.models import api
    from repro_torch.sharding import rules

    arch = coverage.FAMILY_ARCHS[family]
    assert jcov.FAMILY_ARCHS[family] == arch
    jcfg = jconfigs.apply_overrides(jconfigs.get_config(arch), reduced=True)
    shapes = jax.eval_shape(lambda: japi.init_params(jcfg,
                                                     jax.random.key(0)))
    want: dict = {}
    jax.tree_util.tree_map_with_path(
        lambda p, leaf: want.setdefault(jcov._leaf_name(p), set()).add(
            tuple(leaf.shape)), shapes)
    got: dict = {}
    for name, shape in coverage.param_leaves(coverage.family_config(family)):
        got.setdefault(name, set()).add(shape)
    assert got == want
    cfg = coverage.family_config(family)
    spec = api.make_spec(_with(cfg, kernel_policy="pallas"),
                         mult="trunc2x2", device="meta")
    prepared = api.prepare_params(api.init_params(cfg, device="meta"), cfg,
                                  spec)
    fields = {str(p[-1]) for p, _ in rules.tree_paths(prepared)
              if isinstance(p[-1], rules.Attr)}
    assert "wq_t" in fields
    assert {rules.leaf_name(p)[0] for p, _ in rules.tree_paths(prepared)} \
        == set(want)


def _with(cfg, **kw):
    import dataclasses
    return dataclasses.replace(cfg, **kw)


# --------------------------------------------------------------------------
# CUDA kernel contracts (PC)
# --------------------------------------------------------------------------

def test_launch_model_constants():
    """The model's bytes, spelled out from csrc/ (qgemm.cu PL0_SMEM,
    LrLayout<BN>::SMEM, skinny.cu SK_SMEM_MAX, flash_attention.cu
    fa_smem_bytes)."""
    from repro_torch.kernels import approx_qgemm as qk
    assert qk.plane0_smem_bytes() == 4 * (64 + 64) * (128 + 16)
    assert qk.lowrank_smem_bytes(128) == 1024 + 4 * 256 * 128 + 2048 + 32
    assert qk.lowrank_smem_bytes(64) == 1024 + 4 * 192 * 128 + 2048 + 32
    assert qk.SKINNY_SMEM_LIMIT == 1024 + 32768 + 49152 + 4096 + 64 + 16
    assert qk.flash_smem_bytes(64, False) == (8 + 128) * 68 * 4 + 8 * 40 * 4
    assert qk.flash_smem_bytes(64, True) == (16 + 128) * 72 * 2 + 16 * 40 * 4
    m = qk.launch_model("skinny", (4, 2048, 2048, 0, 5, 128))
    assert m.grid == (32, 5, 1) and m.threads == 160
    assert m.smem <= m.smem_limit <= qk.H100_SMEM_OPTIN


def test_contracts_model_drift_pc401():
    """PC401 against a stand-in query: the model agrees with itself, and a
    library that requests other bytes or a larger block is caught."""
    from repro_torch.analysis import contracts
    from repro_torch.kernels import approx_qgemm as qk
    found = contracts.variants("cpu", contracts.CPU_SM_COUNT)
    names = {v: k for k, v in qk.QUERY_IDS.items()}

    def query(kernel, args, drift=0):
        m = qk.launch_model(names[kernel], args)
        return {"smem": m.smem + drift, "smem_limit": m.smem_limit,
                "threads": m.threads, "grid_x": m.grid[0],
                "grid_y": m.grid[1], "grid_z": m.grid[2],
                "static_smem": 0, "max_threads": 1024}

    assert contracts.check_model(found, query)[0] == []
    fs, _ = contracts.check_model(
        found, lambda k, a: query(k, a, drift=16 if k == 3 else 0))
    assert fs and {f.code for f in fs} == {"PC401"}
    assert all("skinny" in f.message for f in fs)


def test_contracts_split_plans_pc402(monkeypatch):
    from repro_torch.analysis import contracts
    from repro_torch.kernels import qgemm
    gemms = [("t", 4, 2048, 2048, 0), ("t", 128, 2048, 2048, 0)]
    assert contracts.check_plans(gemms) == []
    real = qgemm.plane0_split_plan
    # a plan whose chunks stop short of K
    monkeypatch.setattr(qgemm, "plane0_split_plan",
                        lambda k, s: (real(k, s)[0], 64))
    fs = contracts.check_plans(gemms)
    assert fs and {f.code for f in fs} == {"PC402"}
    monkeypatch.setattr(qgemm, "plane0_split_plan", real)
    # a unit that leaves splits empty
    monkeypatch.setattr(qgemm, "skinny_gran", lambda k, s: 4096)
    fs = contracts.check_plans(gemms)
    assert fs and {f.code for f in fs} == {"PC402"}


def test_contracts_dispatch_limit_pc403():
    from repro_torch.analysis import contracts
    from repro_torch.kernels import approx_qgemm as qk
    found = contracts.variants("cpu", contracts.CPU_SM_COUNT)
    assert contracts.check_dispatch(found, qk.H100_SMEM_OPTIN) == []
    fs = contracts.check_dispatch(found, 64 * 1024)
    assert fs and {f.code for f in fs} == {"PC403"}
    assert any(f.message.startswith("plane0") for f in fs)


def test_contracts_ktail_pc404(monkeypatch):
    """A regression that stops masking the mapped K tail (k_valid ignored
    in the low-rank planes) is caught."""
    from repro_torch.analysis import contracts
    from repro_torch.kernels import qgemm
    assert contracts.check_ktail("cpu") == []
    real = qgemm.planes_plain
    monkeypatch.setattr(qgemm, "planes_plain",
                        lambda *a, k_valid=None, **k: real(*a, **k))
    fs = contracts.check_ktail("cpu")
    assert fs and {f.code for f in fs} == {"PC404"}
    assert {f.path for f in fs} == {"csrc/qgemm:fused", "csrc/skinny:skinny"}


def test_contracts_tuning_cache_pc405(tmp_path, monkeypatch):
    from repro_torch.analysis import contracts
    from repro_torch.kernels import autotune
    path = str(tmp_path / "tuning.json")
    card = "NVIDIA H100 80GB HBM3|sm132"
    small = "Tiny Card|sm8"
    cache = autotune._empty_cache()
    cache["entries"] = {
        f"{card}|m4_k2048_n2048|trunc|r0": autotune.TunedPlan(
            "fused", 64, splits=4, skinny=True).as_dict(),
        f"{card}|m128_k2048_n2048|trunc|r0": autotune.TunedPlan(
            "fused", 64, splits=2).as_dict(),
        # 40 splits of K = 256: more than its 32-byte units
        f"{card}|m4_k256_n2048|trunc|r0": autotune.TunedPlan(
            "fused", 64, splits=40, skinny=True).as_dict(),
        # a plane-0 split count beyond K's 64-byte tiles
        f"{card}|m128_k256_n2048|trunc|r0": autotune.TunedPlan(
            "fused", 64, splits=9).as_dict(),
        f"{card}|m128_k2048_n2048|lowrank|r2": autotune.TunedPlan(
            "fused", 96).as_dict(),
        # fine on an H100, above the small card's 64 KiB
        f"{small}|m128_k2048_n2048|lowrank|r2": autotune.TunedPlan(
            "fused", 128).as_dict(),
    }
    autotune.save_cache(cache, path)
    monkeypatch.setitem(contracts.CARD_SMEM_OPTIN, "Tiny", 64 * 1024)
    fs = contracts.check_tuning_cache(path)
    assert {f.code for f in fs} == {"PC405"}
    assert sorted(re.search(r"\|(m\d+_k\d+_n\d+)\|", f.message).group(1)
                  for f in fs) == [
        "m128_k2048_n2048", "m128_k2048_n2048", "m128_k256_n2048",
        "m4_k256_n2048"]
    assert any("Tiny Card" in f.message and "65536" in f.message
               for f in fs)


def test_contracts_clean_on_cpu():
    from repro_torch.analysis import contracts
    report = {}
    assert [f.render() for f in contracts.check(device="cpu",
                                                report=report)] == []
    kinds = {k for k, _ in report["variants"]}
    assert kinds == {"quantize_rows", "plane0", "plane0_reduce", "skinny",
                     "fused", "fused_b_planes", "flash_attention"}
    assert report["limit"] == 232448


def test_runtime_checkers_raise_without_a_gpu(monkeypatch):
    from repro_torch.analysis import contracts, retrace
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for check in (contracts.check, retrace.check):
        with pytest.raises(RuntimeError, match="CUDA"):
            check()


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------

def test_cli_json_report_clean_lint(tmp_path):
    from repro_torch.analysis import cli
    out = tmp_path / "report.json"
    rc = cli.run(["--checks", "jit,sharding", "--format", "json",
                  "--out", str(out)])
    assert rc == 0
    rep = json.loads(out.read_text())
    assert set(rep) == {"checks", "findings", "open", "suppressed",
                        "stale_baseline_entries", "errors"}
    assert rep["checks"] == ["jit", "sharding"] and rep["open"] == 0
    assert rep["errors"] == [] and rep["suppressed"] > 0


def test_cli_exit_1_on_findings_and_baseline_suppression(hazard_tree,
                                                         tmp_path):
    from repro_torch.analysis import cli
    assert cli.run(["--checks", "jit", "--root", str(hazard_tree)]) == 1
    bad = os.path.join("src", "repro_torch", "serving", "engine.py")
    baseline = tmp_path / "b.json"
    baseline.write_text(json.dumps(
        [{"code": c, "path": bad, "reason": "seeded"}
         for c in ("JH101", "JH102", "JH103")]))
    out = tmp_path / "rep.json"
    rc = cli.run(["--checks", "jit", "--root", str(hazard_tree),
                  "--baseline", str(baseline), "--format", "json",
                  "--out", str(out)])
    assert rc == 0
    rep = json.loads(out.read_text())
    assert rep["open"] == 0 and rep["suppressed"] == 3


def test_cli_exit_2_when_a_checker_crashes(monkeypatch, tmp_path):
    """No GPU and no --device cpu: the runtime checker raises, the CLI
    reports it and exits 2."""
    from repro_torch.analysis import cli
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "rep.json"
    rc = cli.run(["--checks", "kernels", "--format", "json", "--out",
                  str(out)])
    assert rc == 2
    rep = json.loads(out.read_text())
    assert rep["errors"][0]["checker"] == "kernels"
    assert "CUDA" in rep["errors"][0]["error"]


def test_cli_rejects_unknown_checker():
    from repro_torch.analysis import cli
    with pytest.raises(SystemExit):
        cli.run(["--checks", "pallas"])


def test_importing_main_runs_nothing(monkeypatch):
    import importlib
    import sys
    monkeypatch.setattr(sys, "argv", ["x", "--checks", "nope"])
    sys.modules.pop("repro_torch.analysis.__main__", None)
    importlib.import_module("repro_torch.analysis.__main__")


def test_checked_in_baseline_is_valid():
    b = Baseline.load(os.path.join(REPO, "analysis-baseline-torch.json"))
    assert isinstance(b.entries, list)


def test_docs_list_every_finding_code():
    doc = open(os.path.join(REPO, "docs", "ANALYSIS_TORCH.md")).read()
    for code, desc in fmod.CODES.items():
        assert f"`{code}`" in doc, f"docs/ANALYSIS_TORCH.md missing {code}"
    # the JAX package's codes with no counterpart are named with why
    assert "JH104" in doc and "REPRO_VMEM_BUDGET" in doc
