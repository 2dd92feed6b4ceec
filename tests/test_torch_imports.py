"""repro_torch stands alone: no module of it imports JAX or the JAX
package, and its entry points never fall back to the CPU on their own."""

import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"

_PROBE = """
import json, pkgutil, importlib, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_no_module_imports_jax_or_the_jax_package():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert "repro_torch.serving.engine" in res["modules"]
    for name in ("paged", "paging", "arena"):
        assert f"repro_torch.serving.{name}" in res["modules"]
    assert "repro_torch.kernels.qgemm" in res["modules"]
    for name in ("kernels.autotune", "roofline.analysis"):
        assert f"repro_torch.{name}" in res["modules"]
    for name in ("mamba2", "rglru", "attention", "moe"):
        assert f"repro_torch.models.{name}" in res["modules"]
    for name in ("workloads", "accelerator", "carbon", "dataflow", "target",
                 "ga", "ga_batched", "calibrate", "codesign"):
        assert f"repro_torch.core.{name}" in res["modules"]
    assert "repro_torch.launch.codesign" in res["modules"]
    for name in ("grid", "meter", "total", "replica", "router", "chaos"):
        assert f"repro_torch.fleet.{name}" in res["modules"]
    assert "repro_torch.train.fault" in res["modules"]
    assert "repro_torch.launch.fleet" in res["modules"]
    for name in ("train", "train.optimizer", "train.train_step",
                 "train.checkpoint", "launch.train"):
        assert f"repro_torch.{name}" in res["modules"]
    assert res["bad"] == []


def test_entry_points_raise_without_cuda(monkeypatch):
    """Called without `device` on a machine with no CUDA device, the entry
    points raise instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from repro_torch import configs
    from repro_torch.device import resolve_device
    from repro_torch.models import api
    from repro_torch.fleet.replica import Replica
    from repro_torch.launch.fleet import build_fleet
    from repro_torch.launch.train import main as train_main
    from repro_torch.serving import Engine, PagedEngine
    from repro_torch.train import train_step as ts
    cfg = configs.reduced(configs.get_config("tinyllama-1.1b"),
                          mult="trunc2x2")
    for call in (lambda: api.init_params(cfg),
                 lambda: build_fleet(cfg, capacity=1, max_len=16),
                 lambda: Replica("a", cfg, capacity=1, max_len=16),
                 lambda: api.make_spec(cfg),
                 lambda: api.init_cache(cfg, 1, 8),
                 lambda: Engine(cfg),
                 lambda: PagedEngine(cfg, prefill_chunk=8,
                                     draft_tier="trunc4x4"),
                 lambda: ts.make_train_fns(cfg, ts.StepOptions()),
                 lambda: train_main(["--reduced", "--steps", "1"]),
                 lambda: resolve_device("cuda")):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")


def test_codesign_entry_points_raise_without_cuda(monkeypatch):
    """The co-design core's device entry points default to the card too."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from repro_torch.core import calibrate, codesign, dataflow
    from repro_torch.core import ga_batched as gb
    from repro_torch.core import multipliers as mm
    from repro_torch.launch import codesign as launch
    mults = [mm.exact_multiplier(), mm.truncated(2, 2)]
    space = gb.build_space("vgg16", 7, 30.0, 2.0, mults=mults, device="cpu")
    for call in (lambda: dataflow.batched_fps("vgg16", [8], [8], [64], 7),
                 lambda: gb.build_space("vgg16", 7, 30.0, 2.0, mults=mults),
                 lambda: space.tables(),
                 lambda: gb.exhaustive_best(space),
                 lambda: gb.run_ga_batched("vgg16", 7, 30.0, 2.0,
                                           space=space),
                 lambda: codesign.run_scenarios(
                     [codesign.Scenario("vgg16", 7)], mults=mults),
                 lambda: calibrate.calibrate_gemm(m=8, k=8, n=8),
                 lambda: calibrate.calibrate_serving(),
                 lambda: launch.run(steps=1)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
