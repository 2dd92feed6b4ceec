"""LUT-level analysis of approximate multipliers.

An approximate 8-bit multiplier is fully characterized by its 256x256 product
LUT (indexed by the uint8 bit patterns of the two's-complement operands).
This module computes the standard error metrics used in the approximate-
computing literature and the *low-rank error factorization* that makes the
multiplier expressible as plain int8 matmuls (see DESIGN.md §3):

    E(a, b)  = a*b - m(a, b)                      (error surface)
    E       ~= sum_r  fu[r][ua] * fv[r][ub]       (truncated SVD)

so that  approx_matmul(A, B) ~= A@B - sum_r U_r(A) @ V_r(B)  with per-operand
256-entry table maps U_r, V_r -- no 2-D gathers, all matmuls.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import netlist as nlmod

MAX_ABS_PRODUCT = 128 * 128  # |a*b| <= 16384 for int8


@dataclasses.dataclass(frozen=True)
class ErrorStats:
    med: float          # mean |error|
    nmed: float         # med / max|product|
    mred: float         # mean relative error (over nonzero exact products)
    wce: int            # worst-case |error|
    error_rate: float   # fraction of (a,b) pairs with any error
    mse: float

    def as_dict(self) -> dict[str, float]:
        return dataclasses.asdict(self)


def error_surface(lut: np.ndarray) -> np.ndarray:
    """E = exact - approx, (256, 256) int64."""
    return nlmod.exact_lut().astype(np.int64) - lut.astype(np.int64)


def error_stats(lut: np.ndarray) -> ErrorStats:
    e = error_surface(lut).astype(np.float64)
    exact = nlmod.exact_lut().astype(np.float64)
    ae = np.abs(e)
    nz = np.abs(exact) > 0
    mred = float(np.mean(ae[nz] / np.abs(exact[nz]))) if nz.any() else 0.0
    return ErrorStats(
        med=float(ae.mean()),
        nmed=float(ae.mean() / MAX_ABS_PRODUCT),
        mred=mred,
        wce=int(ae.max()),
        error_rate=float((ae > 0).mean()),
        mse=float((e * e).mean()),
    )


@dataclasses.dataclass(frozen=True)
class LowRankError:
    """E ~= fu.T-combination: E[ua, ub] ~= sum_r fu[r, ua] * fv[r, ub]."""
    fu: np.ndarray            # (rank, 256) float32
    fv: np.ndarray            # (rank, 256) float32
    residual_nmed: float      # NMED of (E - reconstruction)
    residual_wce: float
    rank: int

    def reconstruct(self) -> np.ndarray:
        return np.einsum("ru,rv->uv", self.fu.astype(np.float64),
                         self.fv.astype(np.float64))


def lowrank_error(lut: np.ndarray, rank: int) -> LowRankError:
    """Truncated SVD of the error surface, balanced factor scaling."""
    e = error_surface(lut).astype(np.float64)
    if rank <= 0 or not np.any(e):
        z = np.zeros((0, 256), dtype=np.float32)
        return LowRankError(z, z, 0.0 if not np.any(e) else float(
            np.abs(e).mean() / MAX_ABS_PRODUCT),
            float(np.abs(e).max()) if np.any(e) else 0.0, 0)
    u, s, vt = np.linalg.svd(e, full_matrices=False)
    r = min(rank, len(s))
    ss = np.sqrt(s[:r])
    fu = (u[:, :r] * ss).T.astype(np.float32)          # (r, 256)
    fv = (vt[:r, :] * ss[:, None]).astype(np.float32)  # (r, 256)
    rec = np.einsum("ru,rv->uv", fu.astype(np.float64), fv.astype(np.float64))
    resid = e - rec
    return LowRankError(
        fu=fu, fv=fv,
        residual_nmed=float(np.abs(resid).mean() / MAX_ABS_PRODUCT),
        residual_wce=float(np.abs(resid).max()),
        rank=r,
    )


def choose_rank(lut: np.ndarray, tol_nmed: float = 1e-4, max_rank: int = 8
                ) -> LowRankError:
    """Smallest rank whose residual NMED <= tol (capped at max_rank)."""
    best = lowrank_error(lut, 0)
    if best.residual_nmed <= tol_nmed:
        return best
    for r in range(1, max_rank + 1):
        best = lowrank_error(lut, r)
        if best.residual_nmed <= tol_nmed:
            return best
    return best


def effective_rank(lut: np.ndarray, tol_nmed: float = 1e-4, max_rank: int = 16
                   ) -> int:
    return choose_rank(lut, tol_nmed, max_rank).rank
