"""Static analysis and sanitizers of the PyTorch/CUDA port.

Four checkers behind one CLI (`python -m repro_torch.analysis`), the
JAX package's `repro.analysis` carried over to an eager program on the
card:

* ``jit`` (lint.py) — AST lint for host syncs in step-reachable code:
  `.item()` / `.cpu()` / blocking copies / ops sized by the data, Python
  control flow on tensors, numpy on tensors;
* ``retrace`` (retrace.py) — per-step budgets of kernel launches,
  library builds, one-time work and host syncs over the serving
  engines, the batched GA and repeat GEMM calls;
* ``sharding`` (coverage.py) — every family's param/cache/batch leaf
  must match a sharding rule or an explicit exemption;
* ``kernels`` (contracts.py) — the CUDA kernels' shared-memory and grid
  model against the library's own query and the card's opt-in limit,
  the split plans, the K-tail contract and the tuning cache.

See docs/ANALYSIS_TORCH.md for finding codes and suppression formats.
"""

from repro_torch.analysis.findings import (  # noqa: F401
    CODES, Baseline, Finding, apply_suppressions, inline_allowed)
