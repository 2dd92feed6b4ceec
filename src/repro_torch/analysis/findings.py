"""Finding model + suppression/baseline machinery for
`repro_torch.analysis`.

A fork of the JAX package's `repro.analysis.findings` (the port imports
nothing of it): the same `Finding`, `Baseline`, `inline_allowed` and
`apply_suppressions`, with this port's own code registry.  Every checker
emits `Finding` records with a stable per-class code (JHxxx host-sync
lint, RTxxx launch/build budgets, SCxxx sharding coverage, PCxxx CUDA
kernel contracts).  Two suppression channels exist:

* an inline comment on the flagged line — ``# analysis: allow[JH101]
  reason`` — for file-anchored lint findings;
* a checked-in baseline file (``analysis-baseline-torch.json`` at the
  repo root): a list of ``{"code", "path", "reason"}`` entries matched
  on (code, path).  ``path`` is the repo-relative file for lint findings
  and a logical location (e.g. ``serving/engine:decode``) for runtime
  checkers.

The CLI exits non-zero on any *unsuppressed* finding; suppressed ones
still appear in the JSON report with their reasons, so nothing is
silently dropped.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re

#: code -> one-line description, the authoritative registry
#: (docs/ANALYSIS_TORCH.md mirrors this table; tests assert the two stay
#: in sync).  The JAX package's JH104 (a mutable default of a static jit
#: argument) has no counterpart: the port has no static jit arguments.
CODES = {
    # host-sync lint (lint.py)
    "JH101": "host sync (.item()/.tolist()/.cpu()/.numpy()/float()/"
             "np.asarray/torch.cuda.synchronize, or an op whose output "
             "size depends on the data) in a step-reachable function",
    "JH102": "Python control flow on a tensor value in a step-reachable "
             "function",
    "JH103": "numpy op applied to a tensor argument in a step-reachable "
             "function",
    # launch / build / one-time-work budgets (retrace.py)
    "RT201": "a watched step went over its declared budget (kernel "
             "launches, library builds or host syncs)",
    "RT202": "a repeat step with unchanged shapes did one-time work "
             "(a build, a plan miss, skinny scratch growth or a first-use "
             "shared-memory attribute call): the step is not warm",
    # sharding coverage (coverage.py)
    "SC301": "param leaf matches no sharding rule and no exemption",
    "SC302": "decode-cache leaf matches no cache sharding rule",
    "SC303": "batch leaf left unsharded on a data-parallel mesh",
    # CUDA kernel contracts (contracts.py)
    "PC401": "the Python shared-memory or block model of a kernel variant "
             "differs from what the library's launcher requests",
    "PC402": "a split plan or tile width does not tile its operands (an "
             "empty split, K left uncovered, or a width not dividing N)",
    "PC403": "dispatch admits a shape whose modelled shared memory busts "
             "the card's opt-in limit per block",
    "PC404": "K-tail contract violated: a K-padded GEMM (k_valid < K) is "
             "not bit-exact with the unpadded plain version",
    "PC405": "a tuning-cache entry holds a plan its bucket's plan "
             "functions reject, or one whose shared memory busts the "
             "limit of the card it is keyed on",
}

#: finding-code prefix -> checker name (the CLI's --checks names)
CHECKER_OF = {"JH": "jit", "RT": "retrace", "SC": "sharding",
              "PC": "kernels"}

_ALLOW_RE = re.compile(r"#\s*analysis:\s*allow\[([A-Z]{2}\d{3})\]")


@dataclasses.dataclass
class Finding:
    code: str
    path: str            # repo-relative file, or logical location
    message: str
    line: int = 0        # 1-based; 0 when not file-anchored
    checker: str = ""
    suppressed: bool = False
    suppress_reason: str = ""

    def __post_init__(self):
        assert self.code in CODES, f"unregistered finding code {self.code}"
        if not self.checker:
            self.checker = CHECKER_OF[self.code[:2]]

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def render(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        tag = " [suppressed]" if self.suppressed else ""
        return f"{self.code}{tag} {loc}: {self.message}"


def inline_allowed(source_line: str) -> str | None:
    """Code allowed by an inline ``# analysis: allow[CODE]`` comment."""
    m = _ALLOW_RE.search(source_line)
    return m.group(1) if m else None


class Baseline:
    """Checked-in (code, path) suppression list."""

    def __init__(self, entries: list[dict]):
        for e in entries:
            missing = {"code", "path", "reason"} - set(e)
            if missing:
                raise ValueError(f"baseline entry {e} missing {missing}")
            if e["code"] not in CODES:
                raise ValueError(f"baseline entry {e}: unknown code")
        self.entries = entries
        self.hits: set[int] = set()

    @classmethod
    def load(cls, path: str | None) -> "Baseline":
        if path is None or not os.path.exists(path):
            return cls([])
        with open(path) as f:
            return cls(json.load(f))

    def match(self, finding: Finding) -> str | None:
        for i, e in enumerate(self.entries):
            if e["code"] == finding.code and e["path"] == finding.path:
                self.hits.add(i)
                return e["reason"]
        return None

    def unused(self) -> list[dict]:
        """Stale entries (reported so the baseline cannot rot silently)."""
        return [e for i, e in enumerate(self.entries) if i not in self.hits]


def apply_suppressions(findings: list[Finding], baseline: Baseline,
                       root: str) -> list[Finding]:
    """Mark findings covered by the baseline or an inline allow comment."""
    cache: dict[str, list[str]] = {}
    for f in findings:
        reason = baseline.match(f)
        if reason is not None:
            f.suppressed, f.suppress_reason = True, f"baseline: {reason}"
            continue
        if not f.line:
            continue
        if f.path not in cache:
            full = os.path.join(root, f.path)
            try:
                with open(full) as fh:
                    cache[f.path] = fh.read().splitlines()
            except OSError:
                cache[f.path] = []
        lines = cache[f.path]
        if 0 < f.line <= len(lines) and \
                inline_allowed(lines[f.line - 1]) == f.code:
            f.suppressed, f.suppress_reason = True, "inline allow"
    return findings
