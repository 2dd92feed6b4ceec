"""The train step, the counterpart of the JAX package's
`repro.train.train_step`: `make_train_fns` on one device, and the
mesh-bound builders `state_shardings`, `make_train_step`,
`make_prefill_step` and `make_decode_step`.

`make_train_fns(cfg, options)` returns `init_fn(seed) -> state` and
`step_fn(state, batch) -> (state, metrics)`; the state is {"params",
"opt", "step"} with the reference's tree layout.  Gradients come from
`torch.autograd.grad` over the loss of `api.loss_fn`: the approximate
GEMMs' straight-through backward, the blockwise attention's custom
backward, and, under `cfg.remat`, every block rerun in the backward.
Gradient accumulation keeps both of the reference's modes:
"scan_of_grad" (a backward per micro-batch, f32 sums) and "grad_of_scan"
(one backward over the mean of the micro-batch losses).

`make_train_step(cfg, options, mesh)` runs the same step on every rank
of a `launch.mesh.Mesh` (one process per rank, `torch.distributed`).
Each rank keeps its block of every state leaf by `state_shardings`
(params by `rules.param_pspec`: columns over "model", and, under FSDP,
ZeRO-3 rows over "data"); a step gathers the params whole, runs the
forward and backward on the rank's rows of every micro-batch under the
mesh's rules (the model axis runs the GEMMs column-parallel and the
attention on the rank's heads), weights the rank's masked-mean loss by
its share of the micro-batch's mask count, all-reduces the gradients
over (pod, data) (gloo has no reduce-scatter: every rank then holds one
device's whole gradient tree, up to summation order), and updates its
own blocks: AdamW with f32 or bf16 moments block by block under the
whole tree's clip; int8 moments and Adafactor, whose statistics read a
whole leaf, on the gathered moments, keeping the rank's block.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import api, weights
from repro_torch.sharding import ctx, rules
from repro_torch.train import optimizer as opt


@dataclasses.dataclass(frozen=True)
class StepOptions:
    accum_steps: int = 1
    optimizer: str = "adamw"
    moment_dtype: str = "f32"
    lr: float = 3e-4
    total_steps: int = 10000
    warmup_steps: int = 100
    # ZeRO-3 param sharding over "data" (None: `rules.should_fsdp`); one
    # device has nothing to shard
    fsdp: bool | None = None
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


def _accumulate(loss, params: dict, mbs: list[dict], options: StepOptions,
                weights_: list | None = None):
    """(loss value, grads) over the micro-batches `mbs` by the options'
    accumulation mode; `weights_` scales each micro-batch's loss (a
    data-parallel rank's share of it), none on one device."""
    n = len(mbs)

    def part(p, i):
        val = loss(p, mbs[i])
        return val if weights_ is None else val * weights_[i]

    if n > 1 and options.accum_mode == "grad_of_scan":
        return _value_and_grad(
            lambda p, _: sum(part(p, i) for i in range(n)) / n, params, None)
    if n > 1:
        grads = opt.tree_map(lambda p: torch.zeros(
            p.shape, dtype=torch.float32, device=p.device), params)
        lsum = 0.0
        for i in range(n):
            lv, g = _value_and_grad(lambda p, _: part(p, i), params, None)
            grads = opt.tree_map(lambda a, b: a + b.float(), grads, g)
            lsum = lsum + lv
        return lsum / n, opt.tree_map(lambda g: g / n, grads)
    return _value_and_grad(lambda p, _: part(p, 0), params, None)


def _optimizer(options: StepOptions):
    return opt.make_optimizer(
        options.optimizer, lr=options.lr, total_steps=options.total_steps,
        warmup_steps=options.warmup_steps,
        **({"moment_dtype": options.moment_dtype}
           if options.optimizer == "adamw" else {}))


def make_train_fns(cfg: ModelConfig, options: StepOptions,
                   device: str | torch.device | None = None):
    """(init_fn(seed) -> state, step_fn(state, batch) -> (state, metrics))
    on `device` (default: the CUDA device).  `batch` holds tensors on that
    device: "tokens" (b, s) and optionally "labels", "mask", "frames",
    "img"; metrics are {"loss", "gnorm", "step"} as 0-dim tensors.
    `options.fsdp` changes nothing on one device (the reference's
    unsharded step ignores it too)."""
    dev = resolve_device(device)
    spec = None if dev.type == "meta" else api.make_spec(cfg, device=dev)
    init_opt, update_opt = _optimizer(options)

    def init_fn(seed: int = 0) -> dict:
        params = api.init_params(cfg, seed, dev)
        return {"params": params, "opt": init_opt(params),
                "step": torch.zeros((), dtype=torch.int32, device=dev)}

    def loss(params, mb):
        return api.loss_fn(params, mb, cfg, spec)[0]

    def step_fn(state: dict, batch: dict) -> tuple[dict, dict]:
        params = state["params"]
        n = options.accum_steps
        mbs = _split_microbatches(batch, n) if n > 1 else [batch]
        lval, grads = _accumulate(loss, params, mbs, options)
        new_params, new_opt = update_opt(params, grads, state["opt"])
        metrics = {"loss": lval, "gnorm": opt.global_norm(grads),
                   "step": state["step"] + 1}
        return {"params": new_params, "opt": new_opt,
                "step": state["step"] + 1}, metrics

    return init_fn, step_fn


# --- over a mesh ---------------------------------------------------------------

#: optimizer levels between "opt" and a moment's parameter path (dict
#: keys; a `QMoment`'s fields are `rules.Attr`s and stay, as in the JAX
#: package, where they are attribute keys)
_OPT_LEVELS = ("m", "v", "f", "q", "scale", "row", "col", "full")


def abstract_state(cfg: ModelConfig, options: StepOptions) -> dict:
    """The train state's shapes and dtypes, on the "meta" device: nothing
    is allocated, so a full-size config costs nothing."""
    return make_train_fns(cfg, options, "meta")[0](0)


def state_shardings(cfg: ModelConfig, options: StepOptions, mesh) -> Any:
    """One spec tuple per train-state leaf, by the JAX package's rule:
    params by `rules.param_pspec` (FSDP from `options.fsdp`, else
    `rules.should_fsdp(cfg)`); a moment mirrors its parameter's spec (the
    optimizer's levels stripped), and falls back to replicated where that
    spec does not divide it; scalars and step counters replicated.
    Works from `abstract_state`'s shapes (the reference's takes its
    `init_fn` to `eval_shape`)."""
    fsdp = options.fsdp if options.fsdp is not None else \
        rules.should_fsdp(cfg)
    shapes = abstract_state(cfg, options)

    def mk(path, leaf):
        shape = tuple(leaf.shape)
        if path and path[0] == "params":
            return rules.normalize(rules.param_pspec(path[1:], shape, mesh,
                                                     fsdp))
        if not path or path[0] != "opt" or path[-1] == "step" or \
                not shape:
            return ()
        core = [p for p in path[1:]
                if isinstance(p, rules.Attr) or p not in _OPT_LEVELS]
        spec = rules.normalize(rules.param_pspec(tuple(core), shape, mesh,
                                                 fsdp))
        if len(spec) > len(shape) or not all(
                rules._fits(shape[i], mesh, ax) for i, ax in enumerate(spec)):
            return ()
        return spec

    return opt.state_map_with_path(mk, shapes)


def _dp_split(mesh) -> tuple[tuple[str, ...], int, int]:
    """(data-parallel axes of size > 1, their size, this rank's index over
    them, row-major)."""
    axes = tuple(a for a in rules.dp_axes(mesh) if mesh.axis_size(a) > 1)
    size, index = 1, 0
    for a in axes:
        size *= mesh.axis_size(a)
        index = index * mesh.axis_size(a) + mesh.axis_index(a)
    return axes, size, index


def make_train_step(cfg: ModelConfig, options: StepOptions, mesh):
    """(init_fn(seed) -> the rank's state, step(state, global batch) ->
    (state, metrics), the state's specs) on this rank of `mesh` (module
    docstring).  `init_fn` draws the whole state as one device's
    `init_fn` does, then keeps the rank's block of every leaf; `step`
    takes the global batch, as the reference's jitted step does, and
    returns one device's metrics (the loss summed over the data ranks),
    on the mesh's device.  An MoE config under a data axis
    raises: capacity couples a call's rows, so per-rank routing would not
    be the global routing."""
    dp_axes, ndp, dp_index = _dp_split(mesh)
    if cfg.is_moe and ndp > 1:
        raise NotImplementedError(
            f"{cfg.name}: an MoE config trains on the model axis only; "
            "expert capacity couples a call's rows, so splitting them over "
            "data ranks would route differently from one device")
    dev = resolve_device(mesh.device)
    init_one, _ = make_train_fns(cfg, options, dev)
    spec = api.make_spec(cfg, device=dev)
    _, update_opt = _optimizer(options)
    st_sh = state_shardings(cfg, options, mesh)
    blockwise = options.optimizer == "adamw" and \
        options.moment_dtype in ("f32", "bf16")

    def init_fn(seed: int = 0) -> dict:
        return opt.state_map(mesh.block, init_one(seed), st_sh)

    def loss(params, mb):
        return api.loss_fn(params, mb, cfg, spec)[0]

    def rank_rows(mb: dict) -> tuple[dict, torch.Tensor | None]:
        """The rank's rows of a micro-batch and its loss weight."""
        if ndp == 1:
            return mb, None
        b = mb["tokens"].shape[0]
        if b % ndp:
            raise ValueError(f"a micro-batch of {b} rows does not split "
                             f"over {ndp} data ranks")
        rows = b // ndp
        mine = {k: v.narrow(0, dp_index * rows, rows) for k, v in mb.items()}
        count = api.loss_mask(mb).sum()
        return mine, api.loss_mask(mine).sum() / torch.clamp(count, min=1.0)

    def step(state: dict, batch: dict) -> tuple[dict, dict]:
        sh = st_sh["params"]
        params = opt.state_map(mesh.gather_leaf, state["params"], sh)
        n = options.accum_steps
        parts = [rank_rows(mb) for mb in (
            _split_microbatches(batch, n) if n > 1 else [batch])]
        mbs = [p[0] for p in parts]
        wts = None if ndp == 1 else [p[1] for p in parts]
        with ctx.use_rules(mesh, rules.logical_rules(mesh)):
            lval, grads = _accumulate(loss, params, mbs, options, wts)
        grads = opt.tree_map(lambda g: mesh.all_reduce(g, dp_axes), grads)
        lval = mesh.all_reduce(torch.as_tensor(lval), dp_axes)
        gnorm = opt.global_norm(grads)
        kw = {"gnorm": gnorm} if options.optimizer == "adamw" else {}
        if blockwise:
            gblk = opt.state_map(lambda g, s: mesh.block(g, s, copy=False),
                                 grads, sh)
            new_params, new_opt = update_opt(state["params"], gblk,
                                             state["opt"], **kw)
        else:
            whole = opt.state_map(mesh.gather_leaf, state["opt"],
                                  st_sh["opt"])
            new_params, new_opt = update_opt(params, grads, whole, **kw)
            new_params = opt.state_map(mesh.block, new_params, sh)
            new_opt = opt.state_map(mesh.block, new_opt, st_sh["opt"])
        metrics = {"loss": lval, "gnorm": gnorm, "step": state["step"] + 1}
        return {"params": new_params, "opt": new_opt,
                "step": state["step"] + 1}, metrics

    return init_fn, step, st_sh


# --- serving steps -------------------------------------------------------------

def make_prefill_step(cfg: ModelConfig, mesh, max_len: int | None = None):
    """`api.prefill` under the mesh's rules: (params, tokens, extras,
    true_len) -> (logits, cache)."""
    spec = api.make_spec(cfg, device=mesh.device)

    def prefill(params, tokens, extras=None, true_len=None):
        with ctx.use_rules(mesh, rules.logical_rules(mesh)):
            return api.prefill(params, tokens, cfg, spec=spec,
                               max_len=max_len, extras=extras,
                               true_len=true_len)

    return prefill


def make_decode_step(cfg: ModelConfig, mesh):
    """`api.decode_step` under the mesh's rules: (params, cache, tokens,
    extras) -> (logits, cache)."""
    spec = api.make_spec(cfg, device=mesh.device)

    def decode(params, cache, tokens, extras=None):
        with ctx.use_rules(mesh, rules.logical_rules(mesh)):
            return api.decode_step(params, cache, tokens, cfg, spec=spec,
                                   extras=extras)

    return decode


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
