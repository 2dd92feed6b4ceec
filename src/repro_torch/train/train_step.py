"""The train step, the counterpart of the JAX package's
`repro.train.train_step.make_train_fns`, on one device.

`make_train_fns(cfg, options)` returns `init_fn(seed) -> state` and
`step_fn(state, batch) -> (state, metrics)`; the state is {"params",
"opt", "step"} with the reference's tree layout.  Gradients come from
`torch.autograd.grad` over the loss of `api.loss_fn`: the approximate
GEMMs' straight-through backward, the blockwise attention's custom
backward, and, under `cfg.remat`, every block rerun in the backward.
Gradient accumulation keeps both of the reference's modes:
"scan_of_grad" (a backward per micro-batch, f32 sums) and "grad_of_scan"
(one backward over the mean of the micro-batch losses).

The reference's mesh-bound builders (`state_shardings`,
`make_train_step`, `make_prefill_step`, `make_decode_step`) and
`StepOptions(fsdp=True)` wait for the training half of the port's
sharding slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import api, weights
from repro_torch.train import optimizer as opt


@dataclasses.dataclass(frozen=True)
class StepOptions:
    accum_steps: int = 1
    optimizer: str = "adamw"
    moment_dtype: str = "f32"
    lr: float = 3e-4
    total_steps: int = 10000
    warmup_steps: int = 100
    fsdp: bool | None = None      # sharded params: not ported (one device)
    # "grad_of_scan": one backward over the summed micro-batch losses;
    # "scan_of_grad": a backward per micro-batch, gradients summed in f32
    accum_mode: str = "scan_of_grad"


def _split_microbatches(batch: dict, n: int) -> list[dict]:
    def split(x):
        if x.shape[0] % n:
            raise ValueError(f"batch {x.shape[0]} does not split into {n} "
                             "micro-batches")
        return x.reshape(n, x.shape[0] // n, *x.shape[1:])
    parts = {k: split(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def _grad_leaves(params: dict) -> tuple[dict, list]:
    """A copy of `params` whose float leaves are fresh autograd leaves
    (sharing storage), and those leaves in tree order."""
    leaves = []

    def leaf(p):
        p = p.detach().requires_grad_(p.is_floating_point())
        leaves.append(p)
        return p

    return opt.tree_map(leaf, params), leaves


def _value_and_grad(loss, params: dict, batch: dict):
    """(loss value, grads tree in the params' dtypes, zeros where a leaf
    takes no gradient)."""
    tree, leaves = _grad_leaves(params)
    with torch.enable_grad():
        val = loss(tree, batch)
        grads = torch.autograd.grad(val, leaves, allow_unused=True)
    it = iter(torch.zeros_like(p) if g is None else g
              for p, g in zip(leaves, grads))
    return val.detach(), opt.tree_map(lambda _: next(it), params)


def make_train_fns(cfg: ModelConfig, options: StepOptions,
                   device: str | torch.device | None = None):
    """(init_fn(seed) -> state, step_fn(state, batch) -> (state, metrics))
    on `device` (default: the CUDA device).  `batch` holds tensors on that
    device: "tokens" (b, s) and optionally "labels", "mask", "frames",
    "img"; metrics are {"loss", "gnorm", "step"} as 0-dim tensors."""
    if options.fsdp:
        raise NotImplementedError(
            "StepOptions(fsdp=True): sharded train state needs the "
            "training half of the port's sharding slice (its serving half, "
            "tensor-parallel serving, is done); the port trains on one "
            "device")
    dev = resolve_device(device)
    spec = api.make_spec(cfg, device=dev)
    init_opt, update_opt = opt.make_optimizer(
        options.optimizer, lr=options.lr, total_steps=options.total_steps,
        warmup_steps=options.warmup_steps,
        **({"moment_dtype": options.moment_dtype}
           if options.optimizer == "adamw" else {}))

    def init_fn(seed: int = 0) -> dict:
        params = api.init_params(cfg, seed, dev)
        return {"params": params, "opt": init_opt(params),
                "step": torch.zeros((), dtype=torch.int32, device=dev)}

    def loss(params, mb):
        return api.loss_fn(params, mb, cfg, spec)[0]

    def step_fn(state: dict, batch: dict) -> tuple[dict, dict]:
        params = state["params"]
        n = options.accum_steps
        if n > 1 and options.accum_mode == "grad_of_scan":
            mbs = _split_microbatches(batch, n)

            def total_loss(p, _):
                return sum(loss(p, mb) for mb in mbs) / n

            lval, grads = _value_and_grad(total_loss, params, batch)
        elif n > 1:
            grads = opt.tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            lsum = 0.0
            for mb in _split_microbatches(batch, n):
                lv, g = _value_and_grad(loss, params, mb)
                grads = opt.tree_map(lambda a, b: a + b.float(), grads, g)
                lsum = lsum + lv
            grads = opt.tree_map(lambda g: g / n, grads)
            lval = lsum / n
        else:
            lval, grads = _value_and_grad(loss, params, batch)
        new_params, new_opt = update_opt(params, grads, state["opt"])
        metrics = {"loss": lval, "gnorm": opt.global_norm(grads),
                   "step": state["step"] + 1}
        return {"params": new_params, "opt": new_opt,
                "step": state["step"] + 1}, metrics

    return init_fn, step_fn


def batch_to(batch_np: dict, device: str | torch.device) -> dict:
    """A numpy batch (`data.synthetic.batch_for`) as tensors on `device`:
    token ids int64, the rest f32."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(
        device, torch.int64 if k in ("tokens", "labels") else torch.float32)
        for k, v in batch_np.items()}


def state_from_reference(state_np: Any, cfg: ModelConfig,
                         device: str | torch.device | None = None) -> dict:
    """The reference's train state as numpy (`jax.tree_util.tree_map(
    np.asarray, state)`: its `QMoment`s keep their class, with numpy
    fields) -> the port's: params through `weights.from_reference`,
    moments, int8 moments (as `QMoment`s) and step counters as tensors of
    the same dtypes on `device`."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if hasattr(x, "q") and hasattr(x, "scale"):
            return opt.QMoment(conv(x.q), conv(x.scale), tuple(x.shape),
                               int(x.pad))
        arr = np.asarray(x)
        if arr.dtype.name == "bfloat16":
            return torch.from_numpy(arr.astype(np.float32)).to(
                dev, torch.bfloat16)
        return torch.from_numpy(np.array(arr)).to(dev)

    return {"params": weights.from_reference(state_np["params"], cfg, dev),
            "opt": conv(state_np["opt"]), "step": conv(state_np["step"])}
