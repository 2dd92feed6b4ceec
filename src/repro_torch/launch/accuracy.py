"""Accuracy-drop calibration (the ApproxTrain step of the methodology):
train a small CNN on the synthetic shapes task, then measure real top-1
accuracy under each approximate multiplier — the truncation library and
the gate-pruned multipliers of the NSGA-II Pareto front.

  PYTHONPATH=src python -m repro_torch.launch.accuracy
  PYTHONPATH=src python -m repro_torch.launch.accuracy --device cpu

Training is plain float autograd with no multiplier (as in the JAX
package's benchmarks/bench_accuracy.py); evaluation runs every conv and FC
GEMM through the approximate multiplier, on the CUDA kernels by default.
One CSV line per multiplier: name, microseconds, top-1, drop against the
exact network, the GA's NMED->drop proxy, NMED.  The first "pareto:" name
builds the NSGA-II front (about 20 s of CPU when `.cache` holds none).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.approx import gemm as G
from repro_torch.core import multipliers as mm
from repro_torch.data import synthetic
from repro_torch.device import resolve_device
from repro_torch.models import cnn

N_CLASSES = 8
TASK = dict(image=32, n_classes=N_CLASSES, amplitude=0.9, noise=0.55)
MULTIPLIERS = ("trunc1x1", "trunc2x2", "trunc3x3", "trunc4x4",
               "pareto:0.005", "pareto:0.01", "pareto:0.02")

# The GA's proxy mapping multiplier error statistics -> top-1 accuracy
# drop (percent), copied from the JAX package's core/ga.py.
ACC_DROP_NMED_COEF = 55.0   # %drop per unit NMED
ACC_DROP_MRED_COEF = 4.0    # %drop per unit MRED


def proxy_accuracy_drop(mult: mm.ApproxMultiplier) -> float:
    return (ACC_DROP_NMED_COEF * mult.stats.nmed
            + ACC_DROP_MRED_COEF * mult.stats.mred) * 1.0


def _reference_numerics() -> None:
    """Convolutions and matmuls in full f32, with deterministic cuDNN
    algorithms, as the reference computes them: cuDNN's f32 convolution
    defaults to TF32, and its fastest backward algorithms sum in an order
    that changes from run to run, so training would not repeat."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True


def train_small_cnn(steps: int = 260, seed: int = 0,
                    device: str | torch.device | None = None) -> dict:
    """vgg_mini trained by SGD (lr 0.05, batch 64) on the shapes task."""
    _reference_numerics()
    dev = resolve_device(device)
    x, y = synthetic.shapes_classification(512, seed=seed, **TASK)
    xt, yt = torch.from_numpy(x).to(dev), torch.from_numpy(y).long().to(dev)
    params = cnn.init_vgg("vgg_mini", seed=seed, n_classes=N_CLASSES,
                          image=32, device=dev)
    leaves = [t for layer in params["convs"] + params["fcs"]
              for t in layer.values()]
    for t in leaves:
        t.requires_grad_(True)
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        idx = torch.from_numpy(rng.integers(0, 512, 64)).to(dev)
        logits = cnn.vgg_forward(params, xt[idx], "vgg_mini")
        loss = -torch.mean(torch.sum(
            F.log_softmax(logits, -1) * F.one_hot(yt[idx], N_CLASSES), -1))
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            for t, g in zip(leaves, grads):
                t -= 0.05 * g
    for t in leaves:
        t.requires_grad_(False)
    return params


def accuracy(params: dict, spec, seed: int = 1, n: int = 512) -> float:
    """Top-1 of vgg_mini on the first `n` of the 512 held-out images."""
    _reference_numerics()
    x, y = synthetic.shapes_classification(512, seed=seed, **TASK)
    dev = params["convs"][0]["w"].device
    if spec is not None:
        spec = spec.to(dev)
    with torch.no_grad():
        logits = cnn.vgg_forward(params, torch.from_numpy(x[:n]).to(dev),
                                 "vgg_mini", spec=spec)
    return float((logits.argmax(-1).cpu().numpy() == y[:n]).mean())


def report(params: dict, policy: str | None = None) -> list[dict]:
    """Top-1 under the exact network and under each of MULTIPLIERS, with
    `policy` choosing kernels or plain versions."""
    t0 = time.perf_counter()
    base = accuracy(params, None)
    rows = [{"name": "exact", "top1": base,
             "us": (time.perf_counter() - t0) * 1e6}]
    for name in MULTIPLIERS:
        mobj = mm.get_multiplier(name)
        spec = G.from_multiplier(mobj).with_policy(policy)
        t0 = time.perf_counter()
        acc = accuracy(params, spec)
        rows.append({"name": name, "top1": acc,
                     "us": (time.perf_counter() - t0) * 1e6,
                     "drop_pct": 100 * (base - acc),
                     "proxy_pct": proxy_accuracy_drop(mobj),
                     "nmed": mobj.stats.nmed, "mode": spec.mode,
                     "rank": spec.rank})
    return rows


def format_lines(rows: list[dict]) -> list[str]:
    lines = []
    for r in rows:
        if r["name"] == "exact":
            lines.append(f"accuracy_exact,{r['us']:.0f},top1={r['top1']:.4f}")
            continue
        lines.append(
            f"accuracy_{r['name']},{r['us']:.0f},top1={r['top1']:.4f};"
            f"drop_pct={r['drop_pct']:.2f};proxy_pct={r['proxy_pct']:.2f};"
            f"nmed={r['nmed']:.5f}")
    return lines


def run(steps: int = 260, seed: int = 0, policy: str | None = None,
        device: str | torch.device | None = None
        ) -> tuple[dict, list[dict]]:
    """Train, then report: (params, rows); the exact row's time includes
    training, as in the JAX benchmark."""
    t0 = time.perf_counter()
    params = train_small_cnn(steps, seed, device)
    train_us = (time.perf_counter() - t0) * 1e6
    rows = report(params, policy)
    rows[0]["us"] += train_us
    return params, rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=260)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernel-policy", default="",
                    choices=["", "auto", "pallas", "xla"],
                    help="GEMM dispatch (kernels/dispatch.py): 'pallas' = "
                         "the CUDA kernels, 'xla' = the plain PyTorch "
                         "versions")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    _, rows = run(args.steps, args.seed, args.kernel_policy or None,
                  args.device)
    print("\n".join(format_lines(rows)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
