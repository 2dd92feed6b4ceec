"""Checkpoints and the train CLI of the port, on the CPU: the
counterparts of `tests/test_train_infra.py`'s checkpoint tests (round
trip and prune, async and atomic, corruption fallback) with bf16 and
int8-moment (`QMoment`) leaves, the npz + manifest format, and
`python -m repro_torch.launch.train --device cpu --reduced` resuming
from its latest checkpoint (the reference's crash-restart test fails on
this JAX: its CLI writes no checkpoint before the kill)."""

import json
import os
import pathlib
import signal
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.launch import train as launch
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import fault
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]


def _small_state(seed=0):
    g = torch.Generator().manual_seed(seed)
    m = opt._quantize_block(torch.randn(3, 130, generator=g))
    return {"params": {"w": torch.arange(12, dtype=torch.float32).reshape(
                3, 4) + seed,
                       "b": torch.randn(4, generator=g).to(torch.bfloat16)},
            "opt": {"m": {"w": m}, "step": torch.tensor(7, dtype=torch.int32)},
            "step": torch.tensor(7 + seed, dtype=torch.int32)}


def _assert_same(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, opt.QMoment):
        assert (a.shape, a.pad) == (b.shape, b.pad)
        _assert_same(a.q, b.q)
        _assert_same(a.scale, b.scale)
    else:
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_roundtrip_and_prune(tmp_path):
    mgr = ckpt.CheckpointManager(tmp_path, keep_last=2)
    for s in (1, 2, 3, 4):
        mgr.save(_small_state(s), s)
    assert mgr.all_steps() == [3, 4]
    restored, at = mgr.restore(_small_state())
    assert at == 4
    _assert_same(restored, _small_state(4))
    assert restored["params"]["b"].dtype == torch.bfloat16
    back, at = mgr.restore(_small_state(), step=3)
    assert at == 3
    _assert_same(back, _small_state(3))


def test_checkpoint_format_is_npz_and_manifest(tmp_path):
    """One npz array per leaf under the reference's keystr names, bf16 as
    its uint16 bits; the manifest records shape, dtype and CRC32."""
    state = _small_state()
    ckpt.CheckpointManager(tmp_path).save(state, 5)
    d = tmp_path / "step_00000005"
    assert sorted(p.name for p in d.iterdir()) == ["manifest.json",
                                                   "proc_0.npz"]
    manifest = json.loads((d / "manifest.json").read_text())
    assert manifest["step"] == 5 and manifest["format"] == "npz"
    names = ckpt.leaf_names(state)
    assert names == ["['opt']['m']['w'].q", "['opt']['m']['w'].scale",
                     "['opt']['step']", "['params']['b']", "['params']['w']",
                     "['step']"]
    assert list(manifest["leaves"]) == names
    with np.load(d / "proc_0.npz") as z:
        assert sorted(z.files) == sorted(names)
        b = z["['params']['b']"]
        assert b.dtype == np.uint16
        assert manifest["leaves"]["['params']['b']"]["dtype"] == "bfloat16"
        for name, meta in manifest["leaves"].items():
            assert meta["crc"] == zlib.crc32(z[name].tobytes())
            assert meta["shape"] == list(z[name].shape)
    assert torch.equal(torch.from_numpy(b.view(np.int16)).view(
        torch.bfloat16), state["params"]["b"])


def test_checkpoint_async_and_atomic(tmp_path):
    mgr = ckpt.CheckpointManager(tmp_path)
    mgr.save(_small_state(), 1, blocking=False)
    mgr.wait()
    assert mgr.latest_step() == 1
    # a stale .tmp dir (a save cut short) is ignored
    (tmp_path / "step_00000099.tmp").mkdir()
    assert mgr.latest_step() == 1
    _, at = mgr.restore(_small_state())
    assert at == 1


@pytest.mark.parametrize("damage", ["garbage", "truncated", "flipped"])
def test_checkpoint_corruption_falls_back(tmp_path, damage):
    mgr = ckpt.CheckpointManager(tmp_path)
    mgr.save(_small_state(1), 1)
    mgr.save(_small_state(2), 2)
    p = tmp_path / "step_00000002" / "proc_0.npz"
    raw = p.read_bytes()
    if damage == "garbage":
        p.write_bytes(b"garbage")
    elif damage == "truncated":
        p.write_bytes(raw[:len(raw) // 2])
    else:   # the manifest's CRC no longer matches one leaf
        m = json.loads((p.parent / "manifest.json").read_text())
        m["leaves"]["['params']['w']"]["crc"] ^= 1
        (p.parent / "manifest.json").write_text(json.dumps(m))
    restored, at = mgr.restore(_small_state())
    assert at == 1
    _assert_same(restored, _small_state(1))


def test_checkpoint_restore_checks_shapes(tmp_path):
    mgr = ckpt.CheckpointManager(tmp_path)
    mgr.save(_small_state(), 1)
    target = _small_state()
    target["params"]["w"] = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="shape mismatch"):
        mgr.restore(target)
    del target["params"]["w"]
    target["params"]["x"] = torch.zeros(1)
    with pytest.raises(KeyError, match="missing leaf"):
        mgr.restore(target)


def test_train_resumes_to_the_same_state(tmp_path):
    """4 steps with a checkpoint every 2, then on to 6 from it: the same
    params, moments and step, bit for bit, as 6 uninterrupted steps."""
    cfg = configs.reduced(configs.get_config("tinyllama-1.1b"),
                          mult="trunc2x2", kernel_policy="pallas")
    opts = ts.StepOptions(total_steps=6, warmup_steps=2, lr=1e-3,
                          moment_dtype="int8")
    kw = dict(batch=2, seq=16, device="cpu", log_every=100)
    whole = launch.train(cfg, opts, steps=6, **kw)
    first = launch.train(cfg, opts, steps=4, ckpt_dir=str(tmp_path),
                         ckpt_every=2, **kw)
    assert ckpt.CheckpointManager(tmp_path).all_steps() == [2, 4]
    rest = launch.train(cfg, opts, steps=6, ckpt_dir=str(tmp_path),
                        ckpt_every=2, **kw)
    assert rest["start_step"] == 4 and len(rest["losses"]) == 2
    assert first["losses"] + rest["losses"] == whole["losses"]
    _assert_same(rest["state"], whole["state"])


def test_train_checkpoints_and_stops_on_preemption(tmp_path):
    cfg = configs.reduced(configs.get_config("tinyllama-1.1b"))
    guard = fault.PreemptionGuard()
    guard.request()
    out = launch.train(cfg, ts.StepOptions(), steps=5, batch=2, seq=16,
                       device="cpu", ckpt_dir=str(tmp_path), guard=guard)
    assert len(out["losses"]) == 1
    assert ckpt.CheckpointManager(tmp_path).all_steps() == [1]


def test_cli_resumes_from_the_latest_checkpoint(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    args = [sys.executable, "-m", "repro_torch.launch.train",
            "--arch", "tinyllama-1.1b", "--reduced", "--device", "cpu",
            "--mult", "trunc2x2", "--batch", "2", "--seq", "16",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
            "--log-every", "1"]
    out = subprocess.run(args + ["--steps", "4"], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "resumed" not in out.stdout and "done: loss" in out.stdout
    assert ckpt.CheckpointManager(tmp_path).all_steps() == [2, 4]
    out = subprocess.run(args + ["--steps", "6"], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "[train] resumed from step 4" in out.stdout
    assert "[train] step     4 loss" in out.stdout
    assert "[train] step     3 loss" not in out.stdout
    assert "done: loss" in out.stdout
    assert ckpt.CheckpointManager(tmp_path).latest_step() == 6


def _sentinel(signum, frame):
    raise AssertionError("the test's own SIGTERM handler ran")


@pytest.fixture
def own_sigterm():
    """A SIGTERM handler of the test's own, put back as it was after."""
    before = signal.signal(signal.SIGTERM, _sentinel)
    yield
    signal.signal(signal.SIGTERM, before)


def test_preemption_guard_holds_sigterm_only_inside_its_block(own_sigterm):
    with fault.PreemptionGuard() as guard:
        assert signal.getsignal(signal.SIGTERM) is not _sentinel
        os.kill(os.getpid(), signal.SIGTERM)
        assert guard.preempted
    assert signal.getsignal(signal.SIGTERM) is _sentinel


def test_cli_leaves_the_sigterm_handler_as_it_found_it(own_sigterm,
                                                       monkeypatch):
    """`main` run in the caller's process (as chip_smoke.py runs it)
    guards SIGTERM during the loop only: after it returns, and after it
    raises for want of a CUDA device, SIGTERM's handler is the caller's."""
    seen = []
    real_train = launch.train

    def spy(*a, **kw):
        seen.append(signal.getsignal(signal.SIGTERM))
        return real_train(*a, **kw)

    monkeypatch.setattr(launch, "train", spy)
    assert launch.main(["--reduced", "--device", "cpu", "--steps", "1",
                        "--batch", "2", "--seq", "16"]) == 0
    assert len(seen) == 1 and seen[0] is not _sentinel
    assert signal.getsignal(signal.SIGTERM) is _sentinel
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        launch.main(["--reduced", "--steps", "1"])
    assert len(seen) == 1
    assert signal.getsignal(signal.SIGTERM) is _sentinel
