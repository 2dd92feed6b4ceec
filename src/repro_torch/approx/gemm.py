"""Approximate-multiplier GEMM (the system's core compute path).

A `MultSpec` is the tensor-side artifact compiled from a gate-level
`ApproxMultiplier` (core/multipliers.py).  Three execution modes, chosen at
spec-build time from the multiplier's structure (DESIGN.md §3):

  exact    m(a,b) == a*b          -> one int8 product
  trunc    m(a,b) == t(a)*t(b)    -> mask LSBs, one int8 product (bit-exact)
  lowrank  m(a,b) == a*b - E(a,b) -> (R+1) int8 products:
           E ~= sum_r s_r * fu_q[r][a] * fv_q[r][b]  (SVD of the error
           surface, the factors themselves int8-quantized).

Gradients are straight-through: the forward runs the approximate quantized
GEMM, the backward uses the float operands.

Whether the O(mkn) work runs on the CUDA kernels (kernels/qgemm.py) or on
the plain path here is decided per GEMM by `spec.policy` and the operands'
device (kernels/dispatch.py).  Integer products run through
`qgemm_int32`, exact on every device.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.approx import quant


@dataclasses.dataclass(frozen=True)
class MultSpec:
    """Approximate-multiplier spec: structure fields plus the (R, 256) int8
    factor tables and (R,) f32 scales as tensors."""
    name: str
    mode: str                 # "exact" | "trunc" | "lowrank"
    trunc_a: int
    trunc_b: int
    rank: int
    residual_nmed: float      # NMED of (E - quantized low-rank reconstruction)
    nmed: float               # NMED of the multiplier itself
    fu_q: torch.Tensor        # (R, 256) int8   (row r of U factor, by a&0xFF)
    fv_q: torch.Tensor        # (R, 256) int8
    s_r: torch.Tensor         # (R,) f32        (per-rank dequant scale)
    #: kernel-dispatch policy ("auto" | "pallas" | "xla")
    policy: str = "auto"

    @property
    def is_exact(self) -> bool:
        return self.mode == "exact"

    def with_policy(self, policy: str | None) -> "MultSpec":
        """Same spec under a different kernel-dispatch policy (validated)."""
        from repro_torch.kernels import dispatch
        p = dispatch.resolve(policy)
        if p == self.policy:
            return self
        return dataclasses.replace(self, policy=p)

    def to(self, device) -> "MultSpec":
        """Same spec with its tables on `device`."""
        return dataclasses.replace(self, fu_q=self.fu_q.to(device),
                                   fv_q=self.fv_q.to(device),
                                   s_r=self.s_r.to(device))


def _empty_tables() -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    z = torch.zeros((0, 256), dtype=torch.int8)
    return z, z.clone(), torch.zeros((0,), dtype=torch.float32)


def exact_spec() -> MultSpec:
    return MultSpec("exact", "exact", 0, 0, 0, 0.0, 0.0, *_empty_tables())


def from_multiplier(m: Any, rank: int | None = None,
                    tol_nmed: float = 1e-4) -> MultSpec:
    """Compile a core.multipliers.ApproxMultiplier into a MultSpec."""
    from repro_torch.core import lut as lutmod

    if m.stats.wce == 0:
        return dataclasses.replace(exact_spec(), name=m.name)

    pure_trunc = (len(m.pruned_gates) == 0 and (m.trunc_a or m.trunc_b))
    if pure_trunc:
        return MultSpec(m.name, "trunc", m.trunc_a, m.trunc_b, 0, 0.0,
                        m.stats.nmed, *_empty_tables())

    lr = (lutmod.lowrank_error(m.lut, rank) if rank is not None
          else lutmod.choose_rank(m.lut, tol_nmed=tol_nmed, max_rank=8))
    # int8-quantize each rank-1 factor pair; fold quant scales into s_r.
    r = lr.rank
    fu_q = np.zeros((r, 256), np.int8)
    fv_q = np.zeros((r, 256), np.int8)
    s_r = np.zeros((r,), np.float32)
    for i in range(r):
        su = max(np.abs(lr.fu[i]).max(), 1e-12) / 127.0
        sv = max(np.abs(lr.fv[i]).max(), 1e-12) / 127.0
        fu_q[i] = np.clip(np.round(lr.fu[i] / su), -128, 127).astype(np.int8)
        fv_q[i] = np.clip(np.round(lr.fv[i] / sv), -128, 127).astype(np.int8)
        s_r[i] = su * sv
    # measured residual of the *quantized* reconstruction
    e = lutmod.error_surface(m.lut).astype(np.float64)
    rec = np.einsum("ru,rv,r->uv", fu_q.astype(np.float64),
                    fv_q.astype(np.float64), s_r.astype(np.float64))
    resid_nmed = float(np.abs(e - rec).mean() / lutmod.MAX_ABS_PRODUCT)
    return MultSpec(m.name, "lowrank", m.trunc_a, m.trunc_b, r, resid_nmed,
                    m.stats.nmed, torch.from_numpy(fu_q),
                    torch.from_numpy(fv_q), torch.from_numpy(s_r))


# ---------------------------------------------------------------------------
# int8 GEMM primitives (the plain path; kernels/qgemm.py holds the CUDA
# kernels that compute the same thing)
# ---------------------------------------------------------------------------

def _trunc_mask(q: torch.Tensor, t: int) -> torch.Tensor:
    if t <= 0:
        return q
    from repro_torch.kernels.approx_qgemm import signed_trunc_mask
    return torch.bitwise_and(q, signed_trunc_mask(t))


def _table_map(tbl: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """tbl: (256,) int8; q: int8 tensor -> int8 tensor, indexed by q & 0xFF."""
    idx = torch.bitwise_and(q.to(torch.int64), 0xFF)
    return tbl.to(q.device)[idx]


def qgemm_int32(a_q: torch.Tensor, b_q: torch.Tensor) -> torch.Tensor:
    """int8 x int8 -> int32 matmul (contraction over last/first axes),
    exact on every device.  torch's int8 matmul wraps and CUDA has no int32
    matmul, so it runs in float64, which holds every partial sum
    (|sum| < 2^31 << 2^53) exactly."""
    return torch.matmul(a_q.to(torch.float64), b_q.to(torch.float64)
                        ).to(torch.int32)


# ---------------------------------------------------------------------------
# Persistent weight-plane cache (serving-time)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PreparedWeight:
    """Per-(weight, MultSpec) serving-time cache.

      wq      int8 (..., k, n)    per-output-channel quantized weight (the
                                  kernels consume it raw and map it in-kernel)
      wq_t    int8 (..., n, k)    wq K-major, made once for the plane-0,
                                  fused and skinny kernels (every GEMM)
                                  where the kernels run; None elsewhere.
                                  One more byte per weight parameter
      sw      f32  (..., 1, n)    dequant scales
      planes  int8 (..., P', k, n) pre-mapped weight planes for the plain
                                  path: the R table-mapped corrections
                                  (lowrank) or the LSB-masked weight (trunc,
                                  P'=1); empty under the "pallas" policy
      w       the original float weight (same storage as the source params)

    Leading stack dims (layer-stacked params) are kept; `layer(i)` slices
    one layer.  Training must not use prepared weights:
    `approx_matmul_prepared` raises on differentiation."""
    w: torch.Tensor
    wq: torch.Tensor
    sw: torch.Tensor
    planes: torch.Tensor
    mode: str
    mult: str
    wq_t: torch.Tensor | None = None

    def layer(self, i: int) -> "PreparedWeight":
        return dataclasses.replace(
            self, w=self.w[i], wq=self.wq[i], sw=self.sw[i],
            planes=self.planes[i],
            wq_t=None if self.wq_t is None else self.wq_t[i])


def is_prepared(w) -> bool:
    return isinstance(w, PreparedWeight)


def prepare_weight(w: torch.Tensor, spec: MultSpec | None):
    """Quantize (per-output-channel) and pre-map a static weight for the
    spec.  Identity for exact/absent specs.  Accepts stacked (..., k, n)
    leaves (quantized one matrix at a time); scales reduce over the
    contraction dim only.  The pre-mapped
    planes serve the plain path only, so a "pallas"-pinned policy skips
    them; the K-major copy serves the plane-0, fused and skinny kernels,
    so it is made where the kernels run."""
    if spec is None or spec.is_exact or is_prepared(w):
        return w
    from repro_torch.kernels import dispatch
    # one (k, n) matrix at a time: the scales reduce over k only, so this
    # is the whole-stack quantization, with f32 temporaries of one matrix
    # (a (12, 2, 4096, 12288) stack whole would need several of 4.8 GB)
    lead = w.shape[:-2]
    wq = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    sw = torch.empty((*lead, 1, w.shape[-1]), dtype=torch.float32,
                     device=w.device)
    for idx in np.ndindex(*lead):
        wq[idx], sw[idx] = quant.quantize(w[idx], axis=1)
    no_planes = torch.zeros((*w.shape[:-2], 0, *w.shape[-2:]),
                            dtype=torch.int8, device=w.device)
    if dispatch.resolve(spec.policy) == "pallas":
        planes = no_planes
    elif spec.mode == "trunc":
        planes = _trunc_mask(wq, spec.trunc_b).unsqueeze(-3)
    elif spec.mode == "lowrank" and spec.rank:
        planes = torch.stack([_table_map(spec.fv_q[r], wq)
                              for r in range(spec.rank)], dim=-3)
    else:  # lowrank rank 0 degenerates to the raw plane
        planes = no_planes
    wq_t = None
    if dispatch.use_kernels(spec.policy, w.device):
        wq_t = wq.transpose(-1, -2).contiguous()
    return PreparedWeight(w=w, wq=wq, sw=sw,
                          planes=planes, mode=spec.mode, mult=spec.name,
                          wq_t=wq_t)


def approx_qgemm_prepared(a_q: torch.Tensor, pw: PreparedWeight,
                          spec: MultSpec) -> torch.Tensor:
    """Plain path against cached weight planes — bit-identical to
    `approx_qgemm(a_q, wq, spec)` with wq freshly quantized.  Planes may be
    absent (prepared under "pallas", then run plain): the weight side is
    then mapped live from the cached `wq`."""
    cached = pw.planes.shape[-3] > 0
    if spec.mode == "trunc":
        a_q = _trunc_mask(a_q, spec.trunc_a)
        wb = pw.planes[0] if cached else _trunc_mask(pw.wq, spec.trunc_b)
        return qgemm_int32(a_q, wb).to(torch.float32)
    acc = qgemm_int32(a_q, pw.wq).to(torch.float32)
    for r in range(spec.rank):
        ua = _table_map(spec.fu_q[r], a_q)
        vb = pw.planes[r] if cached else _table_map(spec.fv_q[r], pw.wq)
        acc = acc - spec.s_r[r].to(acc.device) * \
            qgemm_int32(ua, vb).to(torch.float32)
    return acc


def approx_qgemm(a_q: torch.Tensor, b_q: torch.Tensor, spec: MultSpec
                 ) -> torch.Tensor:
    """Quantized approximate GEMM: int8 (m,k) x int8 (k,n) -> f32 (m,n),
    implementing sum_k m(a[mk], b[kn]) for the spec'd multiplier."""
    if spec.mode == "trunc":
        a_q = _trunc_mask(a_q, spec.trunc_a)
        b_q = _trunc_mask(b_q, spec.trunc_b)
        return qgemm_int32(a_q, b_q).to(torch.float32)
    acc = qgemm_int32(a_q, b_q).to(torch.float32)
    for r in range(spec.rank):
        ua = _table_map(spec.fu_q[r], a_q)
        vb = _table_map(spec.fv_q[r], b_q)
        acc = acc - spec.s_r[r].to(acc.device) * \
            qgemm_int32(ua, vb).to(torch.float32)
    return acc


# ---------------------------------------------------------------------------
# Float-in / float-out approximate matmul
# ---------------------------------------------------------------------------

def _quantize_activations(x2: torch.Tensor, spec: MultSpec, use_kernels: bool
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row (per-token) activation scales.  On the kernel path, f32
    activations go through the fused `quantize_rows` kernel with the trunc
    mask folded in; other dtypes keep the plain quantizer, as in the JAX
    package (the kernel computes in f32, and would round a bf16 input
    differently)."""
    if use_kernels and x2.dtype == torch.float32:
        from repro_torch.kernels import ops as kops
        trunc = spec.trunc_a if spec.mode == "trunc" else 0
        return kops.quantize_rows(x2, trunc=trunc)
    return quant.quantize(x2, axis=0)         # (m, k) -> scales (m, 1)


def _gemm_plan(spec: MultSpec, m: int, k: int, n: int, device):
    from repro_torch.kernels import dispatch
    rank = spec.rank if spec.mode == "lowrank" else 0
    return dispatch.choose_gemm_path(spec.policy, m=m, k=k, n=n,
                                     device=device, mode=spec.mode,
                                     rank=rank)


#: Profiler label of the per-call weight prep in training's forward: the
#: int8 quantize of a raw float weight and its K-major copy for the
#: kernels (a prepared weight keeps both, so serving runs neither).
WEIGHT_PREP = "approx.weight_prep"


def _approx_forward(x: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor,
                    spec: MultSpec, plain,
                    wq_t: torch.Tensor | None = None) -> torch.Tensor:
    """Shared forward: quantize rows, run the planned GEMM, dequantize.
    `plain(xq)` is the plain-path GEMM for this weight; `wq_t` its K-major
    copy, where one is kept (else made here for the kernels)."""
    from repro_torch.kernels import ops as kops
    lead = x.shape[:-1]
    k = x.shape[-1]
    n = wq.shape[-1]
    x2 = x.reshape(-1, k)
    plan = _gemm_plan(spec, x2.shape[0], k, n, x.device)
    xq, sx = _quantize_activations(x2, spec, plan.use_pallas)
    if plan.use_pallas and plan.path == "fused" and wq_t is None:
        with torch.profiler.record_function(WEIGHT_PREP):
            wq_t = wq.T.contiguous()
    if plan.use_pallas:
        acc = kops.approx_qgemm_planned(xq, wq, spec, plan, wq_t)
    else:
        acc = plain(xq)
    out = acc * (sx * sw)                     # (m, n) * (m, 1) * (1, n)
    return out.reshape(*lead, n).to(x.dtype)


class _ApproxMatmul(torch.autograd.Function):
    """Forward through the approximate multiplier; straight-through
    backward on the float operands."""

    @staticmethod
    def forward(ctx, x, w, spec):
        ctx.save_for_backward(x, w)
        with torch.profiler.record_function(WEIGHT_PREP):
            wq, sw = quant.quantize(w, axis=1)    # (k, n) -> (1, n) scales
        return _approx_forward(x, wq, sw, spec,
                               lambda xq: approx_qgemm(xq, wq, spec))

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gf, xf, wf = g.float(), x.float(), w.float()
        dx = torch.einsum("...n,kn->...k", gf, wf).to(x.dtype)
        dw = torch.einsum("...k,...n->kn", xf, gf).to(w.dtype)
        return dx, dw, None


def approx_matmul(x: torch.Tensor, w: torch.Tensor,
                  spec: MultSpec) -> torch.Tensor:
    """x (..., k) @ w (k, n) through the approximate multiplier.
    Activations quantize per row, weights per output channel."""
    return _ApproxMatmul.apply(x, w, spec)


class _ApproxMatmulPrepared(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, pw, spec):
        return _approx_forward(x, pw.wq, pw.sw, spec,
                               lambda xq: approx_qgemm_prepared(xq, pw, spec),
                               pw.wq_t)

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(
            "approx_matmul_prepared is a serving-time path: the weight-plane "
            "cache is stale the moment weights update.  Training must use "
            "approx_matmul on the raw float weight (live re-quantize).")


def approx_matmul_prepared(x: torch.Tensor, pw: PreparedWeight,
                           spec: MultSpec) -> torch.Tensor:
    """x (..., k) @ cached weight through the approximate multiplier — the
    inference twin of `approx_matmul`, bit-identical to it.  Serving only:
    differentiation raises."""
    if pw.mult != spec.name or pw.mode != spec.mode:
        raise ValueError(
            f"PreparedWeight was built for multiplier {pw.mult!r} "
            f"(mode {pw.mode!r}) but is being used with {spec.name!r} "
            f"(mode {spec.mode!r}); re-run prepare_weight for this spec")
    assert pw.wq.ndim == 2, (
        "prepared weights must be per-matrix at use time (slice stacked "
        f"leaves with .layer(i)); got wq shape {tuple(pw.wq.shape)}")
    return _ApproxMatmulPrepared.apply(x, pw, spec)


def spec_from_name(name: str, rank: int | None = None) -> MultSpec:
    """Resolve a multiplier by library name -> MultSpec.  A ':r<k>' suffix
    caps the error-correction rank (e.g. "pareto:0.02:r2")."""
    if name in (None, "", "exact", "none"):
        return exact_spec()
    if ":r" in name:
        base, rstr = name.rsplit(":r", 1)
        return spec_from_name(base, rank=int(rstr))
    from repro_torch.core import multipliers as mm
    return from_multiplier(mm.get_multiplier(name), rank=rank)
