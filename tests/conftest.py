"""Shared fixtures.

`retrace_sanitizer`: a `repro.analysis.retrace.RetraceSanitizer` that
asserts every declared compile budget at teardown — a test that watches
a jitted entry point fails if the entry point retraced beyond budget,
even if all its own assertions passed.

The session also pins $REPRO_TUNING_CACHE to a nonexistent temp path:
kernel dispatch consults the autotune cache, and a TUNING_gemm.json left
in the repo root by a local bench run must not leak measured winners
into tests (tests that WANT a cache point the env var somewhere real).
"""

import os
import tempfile

import pytest

os.environ.setdefault(
    "REPRO_TUNING_CACHE",
    os.path.join(tempfile.mkdtemp(prefix="repro-test-tuning-"),
                 "absent.json"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (the repro_torch CUDA "
        "kernels have no CPU mode); skips without one")


@pytest.fixture
def retrace_sanitizer():
    from repro.analysis.retrace import RetraceSanitizer
    s = RetraceSanitizer()
    yield s
    s.assert_ok()
