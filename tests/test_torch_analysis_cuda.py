"""repro_torch.analysis on the card: the kernel library's host-only query
against the Python launch model (PC401), every variant's shared memory
against the card's opt-in limit (PC403), the K tail of the six kernels
(PC404), and the engines' step budgets (launches, host syncs, one-time
work).  Marked `cuda`: they skip on a machine without a CUDA device.
tests/test_torch_analysis.py holds the rest on the CPU.  This file
imports no JAX, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_analysis_cuda.py
"""

import numpy as np
import pytest
import torch


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_library_query_matches_the_model(cuda_dev):
    """PC401 over every variant the probes reach, and PC403 against the
    card's own opt-in limit with the compiled static bytes."""
    from repro_torch.analysis import contracts
    from repro_torch.device import sm_count
    from repro_torch.kernels import build
    found = contracts.variants(cuda_dev, sm_count(cuda_dev))
    fs, records = contracts.check_model(found, build.query)
    assert [f.render() for f in fs] == []
    limit = contracts.smem_optin(cuda_dev)
    assert contracts.check_dispatch(found, limit, records) == []
    assert contracts.check_ktail(cuda_dev) == []


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["S", "PS"])
def test_cuda_engine_budgets_hold(cuda_dev, case):
    """Launches per step equal to the formula, the declared host syncs per
    step, no one-time work after the first step, on the card."""
    from repro_torch import configs, serving
    from repro_torch.analysis.retrace import instrument_engine
    from repro_torch.serving import Request, SamplingParams
    kw = {} if case == "S" else dict(page_size=8, draft_tier="trunc4x4",
                                     spec_k=3)
    cfg = configs.apply_overrides(configs.get_config(
        "tinyllama-1.1b", mult="trunc2x2", kernel_policy="pallas",
        attn_impl="flash", dtype="float32"), reduced=True)
    cls = "Engine" if case == "S" else "PagedEngine"
    eng = getattr(serving, cls)(cfg, capacity=2, max_len=64,
                                prefill_buckets=(48,), device=cuda_dev,
                                **kw)
    s = instrument_engine(eng)
    rng = np.random.default_rng(3)
    for i, temp in enumerate([0.0, 0.8]):
        eng.submit(Request(f"r{i}", rng.integers(1, 512, 20).tolist(),
                           SamplingParams(max_new_tokens=6, temperature=temp,
                                          top_k=8 if temp else 0, seed=i)))
    eng.run_until_complete()
    assert [f.render() for f in s.findings()] == []
    rep = s.report()
    step = "serving/paged:verify" if case == "PS" else "serving/engine:decode"
    assert rep[step]["syncs_per_call"] == [1]
