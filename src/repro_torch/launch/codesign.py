"""The paper's reproduction for one workload: VGG16 across 7, 14 and 28 nm
with measured (not proxy) accuracy drops, searched by the
population-parallel GA on the device.

Trains vgg_mini on the synthetic shapes task (`launch/accuracy.py`),
measures its top-1 drop under every multiplier of the NSGA-II Pareto front
and the static library through the approximate-GEMM kernels (each
multiplier once, cached by name), feeds that accuracy function to the
batched GA (`core/ga_batched.py`) in `core.codesign.run_codesign`, and
prints the Fig. 2/Fig. 3-style comparison per node.  It also refits the
proxy accuracy-drop coefficients (`ga.ACC_DROP_NMED_COEF` /
`ga.ACC_DROP_MRED_COEF`) from the measured drops.

  PYTHONPATH=src python -m repro_torch.launch.codesign
  PYTHONPATH=src python -m repro_torch.launch.codesign --device cpu

Everything runs on the CUDA device unless `--device cpu` is given; there
the kernels' plain versions evaluate the multipliers.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.approx import gemm as G
from repro_torch.core import codesign, ga, ga_batched, pareto
from repro_torch.core import multipliers as mm
from repro_torch.device import resolve_device
from repro_torch.launch import accuracy as acc

WORKLOAD = "vgg16"
NODES = (7, 14, 28)
FPS_MIN = 30.0
MAX_DROP = 2.0


def default_mults() -> list[mm.ApproxMultiplier]:
    """The Pareto front followed by the static library, each name once
    (the GA registers front multipliers into the library, so a second
    call in one process would list them twice)."""
    mults = pareto.default_front() + list(mm.static_library().values())
    return list({m.name: m for m in mults}.values())


def measured_drops(params: dict, policy: str | None = None):
    """The GA's accuracy function: vgg_mini's top-1 drop (percent, >= 0)
    under a multiplier, measured through the kernels that `policy`
    selects, once per multiplier name.  The function's `cache` maps each
    measured name to its drop."""
    base = acc.accuracy(params, None)
    cache: dict[str, float] = {}

    def drop(m: mm.ApproxMultiplier) -> float:
        if m.name not in cache:
            spec = G.from_multiplier(m).with_policy(policy)
            cache[m.name] = max(0.0, 100.0 * (base - acc.accuracy(params,
                                                                    spec)))
        return cache[m.name]

    drop.cache = cache
    drop.base = base
    return drop


def fit_proxy_coefficients(mults, drop_fn) -> tuple[float, float]:
    """Least-squares refit of `drop ~ a*NMED + b*MRED` on the measured
    drops — how ACC_DROP_NMED_COEF / ACC_DROP_MRED_COEF are calibrated."""
    feats, targets = [], []
    for m in mults:
        if m.is_exact:
            continue
        feats.append([m.stats.nmed, m.stats.mred])
        targets.append(drop_fn(m))
    coef, *_ = np.linalg.lstsq(np.asarray(feats), np.asarray(targets),
                               rcond=None)
    return float(max(coef[0], 0.0)), float(max(coef[1], 0.0))


def run(params: dict | None = None, *, steps: int = 260,
        policy: str | None = None,
        device: str | torch.device | None = None, pop: int = 2048,
        generations: int = 8) -> dict:
    """Train vgg_mini (unless `params` holds a trained one), then run the
    co-design at each of NODES under the measured drops over
    `default_mults()`.  Returns the exact network's top-1, the drop per
    multiplier name, one entry per node (its `CodesignReport` and the
    measured drop of the multiplier the GA chose) and the proxy refit."""
    dev = resolve_device(device)
    if params is None:
        params = acc.train_small_cnn(steps, 0, dev)
    mults = default_mults()
    drop = measured_drops(params, policy)
    cfg = ga_batched.BatchedGAConfig(pop_size=pop, generations=generations,
                                     seed=0)
    nodes_out = []
    for node in NODES:
        rep = codesign.run_codesign(
            WORKLOAD, node, FPS_MIN, MAX_DROP, mults=mults,
            accuracy_fn=drop, engine="batched", batched_cfg=cfg, device=dev)
        chosen = rep.ga_cdp.config.multiplier
        nodes_out.append({"node_nm": node, "report": rep,
                          "chosen_drop_pct": (drop.cache[chosen]
                                              if chosen != "exact" else 0.0)})
    return {"base_top1": drop.base, "drops": dict(drop.cache),
            "nodes": nodes_out, "accuracy_fn": drop, "mults": mults,
            "refit": fit_proxy_coefficients(mults, drop)}


def format_lines(res: dict) -> list[str]:
    lines = [f"exact top-1: {res['base_top1']:.3f}"]
    for entry in res["nodes"]:
        lines.append(f"--- {entry['node_nm']} nm ---")
        lines += entry["report"].summary().splitlines()
        lines.append(f"  measured top-1 drop of chosen multiplier: "
                     f"{entry['chosen_drop_pct']:.2f}%")
    a, b = res["refit"]
    lines.append(f"proxy refit from measured drops: "
                 f"ACC_DROP_NMED_COEF~{a:.1f} (current "
                 f"{ga.ACC_DROP_NMED_COEF}), ACC_DROP_MRED_COEF~{b:.1f} "
                 f"(current {ga.ACC_DROP_MRED_COEF})")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=260,
                    help="vgg_mini SGD steps")
    ap.add_argument("--pop", type=int, default=2048,
                    help="GA population")
    ap.add_argument("--generations", type=int, default=8)
    ap.add_argument("--kernel-policy", default="",
                    choices=["", "auto", "pallas", "xla"],
                    help="GEMM dispatch of the accuracy measurements "
                         "(kernels/dispatch.py): 'pallas' = the CUDA "
                         "kernels, 'xla' = the plain PyTorch versions")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    res = run(steps=args.steps, policy=args.kernel_policy or None,
              device=args.device, pop=args.pop,
              generations=args.generations)
    print("\n".join(format_lines(res)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
