"""Optimizers: AdamW (f32 / bf16 / block-int8 moments) and Adafactor, the
counterpart of the JAX package's `repro.train.optimizer`.

States are trees of nested dicts like the params.  Int8 moments are
`QMoment`s: per-(last-dim block of 128) symmetric int8 with f32 scales,
the parameter's dimensionality kept (last dim padded); second moments
store sqrt(v) under int8 and square on load.  Every update dequantizes,
updates in f32 and requantizes, leaf by leaf, on the params' device; the
step counter and the learning rate stay device tensors, so a step never
waits on the host.  The block scale is absmax times f32(1/127), as
compiled JAX computes `absmax / 127`.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, ClassVar

import torch
import torch.nn.functional as F

from repro_torch.sharding.rules import Attr

BLOCK = 128
#: f32(1 / 127): compiled JAX folds the divide by 127 into this multiply.
_INV_127 = 0.007874015718698502


# --- trees -------------------------------------------------------------------

def tree_leaves(tree: Any) -> list:
    """Leaves of a nested-dict tree in the reference's order (dict keys
    sorted, as `jax.tree_util` flattens them)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """`fn` over the leaves of `tree` and the matching leaves of `rest`
    (trees of the same dict structure, or with leaves of their own where
    `tree` has a leaf)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def state_map_with_path(fn: Callable, state: Any, *rest: Any,
                        path: tuple = ()) -> Any:
    """`fn(path, leaf, *rest_leaves)` over every tensor of a train state
    (nested dicts of tensors and `QMoment`s) and the matching leaves of
    trees of its layout, such as its `train_step.state_shardings` specs.
    A path holds dict keys as str and a `QMoment`'s fields as
    `rules.Attr`, as the JAX package's paths hold its attribute keys; the
    result keeps the state's `QMoment`s, `fn`'s results in their
    fields."""
    if isinstance(state, dict):
        return {k: state_map_with_path(fn, v, *(r[k] for r in rest),
                                       path=(*path, k))
                for k, v in state.items()}
    if isinstance(state, QMoment):
        return dataclasses.replace(state, **{
            f: fn((*path, Attr(f)), getattr(state, f),
                  *(getattr(r, f) for r in rest))
            for f in QMoment.FIELDS})
    return fn(path, state, *rest)


def state_map(fn: Callable, state: Any, *rest: Any) -> Any:
    """`state_map_with_path` without the path: `fn(leaf, *rest_leaves)`."""
    return state_map_with_path(lambda _, *leaves: fn(*leaves), state, *rest)


# --- block-quantized tensor state --------------------------------------------

@dataclasses.dataclass(frozen=True)
class QMoment:
    """int8 moment tensor with per-(last-dim-block) f32 scales: q keeps the
    parameter's dimensionality, its last dim padded to a multiple of
    BLOCK by `pad`; `shape` is the parameter's shape ((1,) for a
    scalar)."""
    q: torch.Tensor
    scale: torch.Tensor
    shape: tuple
    pad: int

    #: the tensor fields, in the JAX package's leaf order
    FIELDS: ClassVar[tuple[str, ...]] = ("q", "scale")


def _quantize_block(x: torch.Tensor) -> QMoment:
    shape = tuple(x.shape)
    if not shape:
        shape = (1,)
        x = x.reshape(1)
    last = shape[-1]
    pad = (-last) % BLOCK
    xp = F.pad(x, (0, pad)) if pad else x
    blocks = xp.reshape(*shape[:-1], -1, BLOCK)
    absmax = blocks.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(absmax, min=1e-12) * _INV_127
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return QMoment(q.reshape(*shape[:-1], last + pad),
                   scale[..., 0].float(), shape, pad)


def _dequantize_block(st: QMoment) -> torch.Tensor:
    blocks = st.q.reshape(*st.q.shape[:-1], -1, BLOCK).float()
    x = (blocks * st.scale[..., None]).reshape(*st.q.shape[:-1], -1)
    if st.pad:
        x = x[..., :-st.pad]
    return x.reshape(st.shape)


def _store(x: torch.Tensor, mode: str):
    if mode == "f32":
        return x.float()
    if mode == "bf16":
        return x.to(torch.bfloat16)
    if mode == "int8":
        return _quantize_block(x)
    raise ValueError(mode)


def _load(st) -> torch.Tensor:
    return _dequantize_block(st) if isinstance(st, QMoment) else st.float()


# --- schedules ---------------------------------------------------------------

def warmup_cosine(step: torch.Tensor, base_lr: float, warmup: int,
                  total: int, min_frac: float = 0.1) -> torch.Tensor:
    """Linear warmup to `base_lr`, then a cosine decay to min_frac x it,
    in f32 as the reference computes it."""
    step = torch.as_tensor(step).float()
    warm = base_lr * step / max(warmup, 1)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = base_lr * (min_frac + (1 - min_frac) * 0.5 *
                     (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup, warm, cos)


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum over leaves (in tree order) of each leaf's f32 sum
    of squares."""
    return torch.sqrt(sum(torch.sum(x.float() ** 2)
                          for x in tree_leaves(tree)))


# --- AdamW -------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10000
    clip_norm: float = 1.0
    moment_dtype: str = "f32"        # "f32" | "bf16" | "int8"


def _store_v(v: torch.Tensor, mode: str):
    """Second moments have a huge dynamic range: int8 stores sqrt(v)."""
    if mode == "int8":
        return _store(torch.sqrt(torch.clamp(v, min=0.0)), mode)
    return _store(v, mode)


def _load_v(st, mode: str) -> torch.Tensor:
    x = _load(st)
    return x * x if mode == "int8" else x


def adamw_init(params: Any, cfg: AdamWConfig) -> dict:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {"m": tree_map(lambda p: _store(zeros(p), cfg.moment_dtype),
                          params),
            "v": tree_map(lambda p: _store_v(zeros(p), cfg.moment_dtype),
                          params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=tree_leaves(params)[0].device)}


def adamw_update(params: Any, grads: Any, state: dict, cfg: AdamWConfig,
                 gnorm: torch.Tensor | None = None) -> tuple[Any, dict]:
    """One AdamW step: clip by global norm, bias-corrected moments,
    decoupled weight decay, the warmup-cosine learning rate.  `gnorm`
    is the norm to clip by, where `grads` are a rank's blocks of a whole
    tree (default: `grads`' own)."""
    step = state["step"] + 1
    stepf = step.float()
    lr = warmup_cosine(step, cfg.lr, cfg.warmup_steps, cfg.total_steps)
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    c1 = 1 - torch.pow(cfg.b1, stepf)
    c2 = 1 - torch.pow(cfg.b2, stepf)

    b1, b2, c_b1 = (torch.tensor(x, device=stepf.device)
                    for x in (cfg.b1, cfg.b2, 1 - cfg.b1))

    def upd(p, g, m_st, v_st):
        g = g.float() * scale
        # b * moment + (1 - b) * g..., one product fused into the add (one
        # rounding) as XLA contracts it: the decay's, but the new
        # gradient's for an int8 first moment (its dequantize multiply
        # comes first).  The int8 moments then keep the reference's codes
        # and block scales.
        if isinstance(m_st, QMoment):
            m = torch.addcmul(cfg.b1 * _load(m_st), g, c_b1)
        else:
            m = torch.addcmul((1 - cfg.b1) * g, _load(m_st), b1)
        v = torch.addcmul((1 - cfg.b2) * g * g,
                          _load_v(v_st, cfg.moment_dtype), b2)
        pf = p.float()
        delta = (m / c1) / (torch.sqrt(v / c2) + cfg.eps) + \
            cfg.weight_decay * pf
        return ((pf - lr * delta).to(p.dtype), _store(m, cfg.moment_dtype),
                _store_v(v, cfg.moment_dtype))

    outs = tree_map(upd, params, grads, state["m"], state["v"])
    pick = functools.partial(tree_map, tree=outs)
    return (pick(lambda o: o[0]),
            {"m": pick(lambda o: o[1]), "v": pick(lambda o: o[2]),
             "step": step})


# --- Adafactor (factored second moments for >=2-D params) --------------------

@dataclasses.dataclass(frozen=True)
class AdafactorConfig:
    lr: float = 1e-3
    decay: float = 0.999
    eps: float = 1e-30
    clip_rms: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    weight_decay: float = 0.0


def adafactor_init(params: Any, cfg: AdafactorConfig) -> dict:
    def mk(p):
        f32 = dict(dtype=torch.float32, device=p.device)
        if p.ndim >= 2:
            return {"row": torch.zeros(p.shape[:-1], **f32),
                    "col": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)}
        return {"full": torch.zeros(p.shape, **f32)}
    return {"f": tree_map(mk, params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=tree_leaves(params)[0].device)}


def adafactor_update(params: Any, grads: Any, state: dict,
                     cfg: AdafactorConfig) -> tuple[Any, dict]:
    step = state["step"] + 1
    lr = warmup_cosine(step, cfg.lr, cfg.warmup_steps, cfg.total_steps)

    def upd(p, g, f):
        g = g.float()
        g2 = g * g + cfg.eps
        if p.ndim >= 2:
            row = cfg.decay * f["row"] + (1 - cfg.decay) * g2.mean(-1)
            col = cfg.decay * f["col"] + (1 - cfg.decay) * g2.mean(-2)
            rmean = row.mean(-1, keepdim=True)
            vhat = (row / torch.clamp(rmean, min=cfg.eps))[..., None] * \
                col[..., None, :]
            newf = {"row": row, "col": col}
        else:
            vhat = cfg.decay * f["full"] + (1 - cfg.decay) * g2
            newf = {"full": vhat}
        update = g / torch.sqrt(vhat + cfg.eps)
        rms = torch.sqrt(torch.mean(update ** 2))
        update = update / torch.clamp(rms / cfg.clip_rms, min=1.0)
        pf = p.float()
        return (pf - lr * (update + cfg.weight_decay * pf)).to(p.dtype), newf

    outs = tree_map(upd, params, grads, state["f"])
    pick = functools.partial(tree_map, tree=outs)
    return pick(lambda o: o[0]), {"f": pick(lambda o: o[1]), "step": step}


# --- façade ------------------------------------------------------------------

def make_optimizer(kind: str = "adamw", **kw):
    """(init(params) -> state, update(params, grads, state) -> (params,
    state)) for "adamw" or "adafactor", configured by `kw`."""
    if kind == "adamw":
        cfg = AdamWConfig(**kw)
        return (functools.partial(adamw_init, cfg=cfg),
                functools.partial(adamw_update, cfg=cfg))
    if kind == "adafactor":
        cfg = AdafactorConfig(**kw)
        return (functools.partial(adafactor_init, cfg=cfg),
                functools.partial(adafactor_update, cfg=cfg))
    raise ValueError(kind)
