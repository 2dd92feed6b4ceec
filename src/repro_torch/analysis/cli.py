"""`python -m repro_torch.analysis` — run the port's checkers and report.

Exit codes: 0 clean (or all findings suppressed), 1 unsuppressed
findings, 2 a checker itself crashed (infrastructure failure, distinct
from "the repo has findings" so CI can tell them apart).

`--device` is the device of the runtime checkers (`kernels`, `retrace`):
the CUDA device by default, which raises where there is none; `--device
cpu` runs them on the CPU, where the kernels' plain versions run and the
card-only checks (the library query, host syncs) are skipped.  `jit`
and `sharding` are static and take no device.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import traceback

from repro_torch.analysis.findings import Baseline, apply_suppressions

#: checker name -> module path; each module exposes `check(root, device)
#: -> list[Finding]`.  Imported lazily: a broken runtime checker must not
#: take down `--checks jit`.
CHECKERS = {
    "jit": "repro_torch.analysis.lint",
    "sharding": "repro_torch.analysis.coverage",
    "kernels": "repro_torch.analysis.contracts",
    "retrace": "repro_torch.analysis.retrace",
}

DEFAULT_BASELINE = "analysis-baseline-torch.json"


def _repo_root() -> str:
    # src/repro_torch/analysis/cli.py -> the repo root is above src/
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.dirname(os.path.dirname(os.path.dirname(here)))


def run(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="host-sync lint, launch/build budgets, sharding-rule "
                    "coverage and CUDA kernel contracts of repro_torch")
    ap.add_argument("--checks", default=",".join(CHECKERS),
                    help="comma-separated subset of: " + ",".join(CHECKERS))
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--out", default=None,
                    help="write the report here as well as stdout")
    ap.add_argument("--root", default=_repo_root(),
                    help="repo root (default: auto-detected)")
    ap.add_argument("--baseline", default=None,
                    help=f"suppression file (default: "
                         f"<root>/{DEFAULT_BASELINE})")
    ap.add_argument("--device", default=None,
                    help="device of the runtime checkers (default: the "
                         "CUDA device; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)

    names = [c.strip() for c in args.checks.split(",") if c.strip()]
    unknown = [c for c in names if c not in CHECKERS]
    if unknown:
        ap.error(f"unknown checker(s) {unknown}; known: {list(CHECKERS)}")

    baseline_path = args.baseline or os.path.join(args.root,
                                                  DEFAULT_BASELINE)
    baseline = Baseline.load(baseline_path)

    findings, errors = [], []
    for name in names:
        try:
            mod = importlib.import_module(CHECKERS[name])
            findings.extend(mod.check(args.root, device=args.device))
        except Exception:
            errors.append({"checker": name,
                           "error": traceback.format_exc()})
    apply_suppressions(findings, baseline, args.root)
    open_findings = [f for f in findings if not f.suppressed]

    report = {
        "checks": names,
        "findings": [f.as_dict() for f in findings],
        "open": len(open_findings),
        "suppressed": len(findings) - len(open_findings),
        "stale_baseline_entries": baseline.unused(),
        "errors": errors,
    }
    if args.format == "json":
        text = json.dumps(report, indent=2)
    else:
        lines = [f.render() for f in findings]
        for e in errors:
            lines.append(f"ERROR {e['checker']}: checker crashed\n"
                         f"{e['error']}")
        for e in report["stale_baseline_entries"]:
            lines.append(f"stale baseline entry: {e}")
        lines.append(f"analysis: {len(open_findings)} open, "
                     f"{report['suppressed']} suppressed "
                     f"({', '.join(names)})")
        text = "\n".join(lines)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")

    if errors:
        return 2
    return 1 if open_findings else 0


def main() -> None:
    sys.exit(run())
