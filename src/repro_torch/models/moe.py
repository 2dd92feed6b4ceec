"""Mixture-of-Experts FFN with capacity-based top-k routing (Switch /
GShard style), the counterpart of the JAX package's `models/moe.py`.

The router runs in exact f32 (error-sensitive control logic: the paper
approximates the MAC arrays only).  Capacity is per call, from the number
of tokens `t` the call routes, so the rows of one call share it: a token
takes the next position in its expert in flattened (b, s) row order, and
a token at or past the capacity is dropped.  A decode row's output
therefore depends on the other rows of its batch, and a chunked prefill
differs from a whole one, in the reference as here.

Dispatch scatters into an (e, capacity + 1, d) block whose last row
catches the dropped tokens (no host sync on the routing), and every
expert's SwiGLU runs on its (capacity, d) block through `AL.gemm`, one
expert after another — the literal counterpart of the reference's
`jax.vmap(AL.gemm)`: the same work, and a launch count fixed by the
config, not by the routing.  The expert stacks may be `PreparedWeight`s
of shape (e, k, n) (sliced per expert with `.layer(i)`) or raw float
stacks.  The reference's sharding hints are no-ops on one device and are
left out.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from repro_torch.approx import gemm as gemm_mod
from repro_torch.approx import layers as AL
from repro_torch.models import common as C

#: Open `recording()` logs; `moe_ffn` appends its routing to each.
_LOGS: list[list] = []


@dataclasses.dataclass(frozen=True)
class Routing:
    """One call's routing, as tensors on the call's device:
    `expert_idx` (t, top_k), each token slot's `position` in its expert
    (t, top_k), `keep` (t, top_k) bool (False: dropped), `gate_vals`
    (t, top_k) f32 (normalised), `probs` (t, e) f32, `density` (e,) f32
    (tokens routed to each expert over t, summed over the slots), and the
    call's `capacity`."""
    expert_idx: torch.Tensor
    position: torch.Tensor
    keep: torch.Tensor
    gate_vals: torch.Tensor
    probs: torch.Tensor
    density: torch.Tensor
    capacity: int

    @property
    def dropped(self) -> torch.Tensor:
        """Token slots dropped by the capacity (a 0-dim tensor)."""
        return (~self.keep).sum()


@contextlib.contextmanager
def recording():
    """Collect the `Routing` of every `moe_ffn` call made inside the
    block, in call order (tensors stay on the device: no sync)."""
    log: list[Routing] = []
    _LOGS.append(log)
    try:
        yield log
    finally:
        _LOGS.remove(log)


def capacity_of(t: int, e: int, top_k: int, capacity_factor: float) -> int:
    """Expert capacity of a call routing `t` tokens: the reference's
    expression, so the Python float rounds the same way."""
    return max(1, int(capacity_factor * top_k * t / e))


def no_drop_factor(e: int, top_k: int) -> float:
    """The capacity factor e / top_k: `capacity_of` is then t, every
    expert has room for every token of a call, nothing is dropped, and no
    row's output depends on the other rows of its call."""
    return e / top_k


def no_drop(cfg):
    """`cfg` with capacity_factor = `no_drop_factor` (the weights'
    shapes, and so the params, stay the same)."""
    return dataclasses.replace(
        cfg, capacity_factor=no_drop_factor(cfg.n_experts, cfg.top_k))


def route(x: torch.Tensor, router, top_k: int, capacity_factor: float
          ) -> Routing:
    """x (t, d), router (d, e) -> the call's `Routing`.

    Softmax of the f32 logits, then top-k with ties broken towards the
    lower expert index (a stable descending sort, as `jax.lax.top_k`
    orders them), normalised by max(sum, 1e-9).  Per slot, a token's
    position in its expert is cumsum(onehot) - onehot over the rows in
    order; it is kept while the position is under the capacity."""
    router = AL._as_weight(router, torch.float32)
    t = x.shape[0]
    e = router.shape[1]
    capacity = capacity_of(t, e, top_k, capacity_factor)
    logits = torch.matmul(x.to(torch.float32), router.to(torch.float32))
    probs = torch.softmax(logits, dim=-1)
    expert_idx = torch.sort(probs, dim=-1, descending=True,
                            stable=True).indices[:, :top_k]
    gate_vals = probs.gather(-1, expert_idx)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    onehot = torch.nn.functional.one_hot(expert_idx, e)  # (t, k, e)
    pos = torch.cumsum(onehot, dim=0) - onehot
    position = (pos * onehot).sum(-1)                     # (t, k)
    density = (onehot.sum(0).to(torch.float32) / t).sum(0)
    return Routing(expert_idx, position, position < capacity, gate_vals,
                   probs, density, capacity)


def _expert(w, i: int):
    """Expert i's (k, n) matrix of a stack: prepared or float."""
    return w.layer(i) if gemm_mod.is_prepared(w) else w[i]


def _expert_gemm(x_e: torch.Tensor, w_e, spec) -> torch.Tensor:
    """Per-expert approximate GEMM over every expert: x_e (e, c, k) with
    expert i's (k, n) weight -> (e, c, n)."""
    return torch.stack([AL.gemm(x_e[i], _expert(w_e, i), spec)
                        for i in range(x_e.shape[0])])


def moe_ffn(x: torch.Tensor, router, we_gate, we_up, we_down, top_k: int,
            capacity_factor: float, spec) -> tuple[torch.Tensor,
                                                   torch.Tensor]:
    """x (t, d); router (d, e); we_* (e, d, f) / (e, f, d), prepared or
    float.  Returns (out (t, d), aux): aux is the load-balance loss
    (sum_e density_e / top_k * mean router prob_e, times e)."""
    r = route(x, router, top_k, capacity_factor)
    for log in _LOGS:
        log.append(r)
    t, d = x.shape
    e = r.probs.shape[1]
    cap = r.capacity
    exact = spec is None or spec.is_exact
    if exact:
        we_gate, we_up, we_down = (AL._as_weight(w, x.dtype)
                                   for w in (we_gate, we_up, we_down))
    out = torch.zeros((t, d), dtype=torch.float32, device=x.device)
    for slot in range(top_k):
        idx = r.expert_idx[:, slot]
        keep = r.keep[:, slot]
        at = torch.clamp(r.position[:, slot], max=cap)
        # dispatch: row `cap` of each expert catches the dropped tokens
        x_e = torch.zeros((e, cap + 1, d), dtype=x.dtype, device=x.device)
        x_e[idx, at] = torch.where(keep[:, None], x, 0)
        x_e = x_e[:, :cap]
        if exact:
            g = torch.einsum("ecd,edf->ecf", x_e, we_gate)
            u = torch.einsum("ecd,edf->ecf", x_e, we_up)
            o_e = torch.einsum("ecf,efd->ecd", C.silu(g) * u, we_down)
        else:
            g = _expert_gemm(x_e, we_gate, spec)
            u = _expert_gemm(x_e, we_up, spec)
            o_e = _expert_gemm(C.silu(g) * u, we_down, spec)
        # combine: a dropped token's gather is masked by where, so no NaN
        # or inf of another row reaches it
        gathered = o_e[idx, torch.clamp(at, max=cap - 1)]
        out = out + torch.where(keep[:, None], gathered.to(torch.float32),
                                0.0) * r.gate_vals[:, slot][:, None]
    aux = (r.density / top_k * r.probs.mean(0)).sum() * e
    return out.to(x.dtype), aux
