"""Analytical loop-nest performance model (nn-dataflow / Tangram style).

Estimates per-layer cycles for an NVDLA-style accelerator:

  * compute: the MAC array is (pe_rows x pe_cols) = (C-parallel x K-parallel);
    one output spatial position per cycle per (C,K) tile pass;
  * memory: DRAM traffic under the best of two canonical loop orders
    (weight-stationary vs. output/ifmap-stationary) with a discrete tiling
    search constrained by the global buffer (double-buffered), exactly the
    trade-off nn-dataflow explores;
  * the layer runs at max(compute, memory) cycles (perfect double-buffer
    overlap — an optimistic but standard assumption).

FPS = freq / sum(layer cycles).  All operands int8, psums int32.

Multi-die targets (`n_dies > 1`) partition the output channels (NVDLA
Atomic-K / the TP "model" axis) across identical dies: each die runs the
layer with K/n output channels on a (rows x cols/n) array, streams its
own weight/ofmap slice through its own DRAM channel (aggregate bandwidth
scales with the die count — the chiplet bandwidth lever), and replicates
the ifmap.  Between layers the channel-partitioned activations all-gather
over the D2D links (UCIe-class `D2D_GBPS`), modeled like the DRAM term
(overlapped: the layer runs at max(compute, memory, d2d)) plus a fixed
per-layer hop latency.  `n_dies == 1` is bit-for-bit the monolithic model.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from . import accelerator as accmod
from . import carbon as carbonmod
from . import workloads as wl


#: Die-to-die link bandwidth [GB/s] (UCIe-class, per neighbor link) and the
#: fixed per-layer synchronization latency paid once per all-gather.
D2D_GBPS = 32.0
D2D_HOP_CYCLES = 2000.0


@dataclasses.dataclass(frozen=True)
class LayerPerf:
    name: str
    compute_cycles: float
    memory_cycles: float
    dram_bytes: float
    utilization: float
    d2d_cycles: float = 0.0     # inter-die all-gather (overlapped)
    hop_cycles: float = 0.0     # fixed per-layer D2D sync latency (serial)

    @property
    def cycles(self) -> float:
        return max(self.compute_cycles, self.memory_cycles,
                   self.d2d_cycles) + self.hop_cycles


@dataclasses.dataclass(frozen=True)
class WorkloadPerf:
    layers: tuple[LayerPerf, ...]
    total_cycles: float
    fps: float
    avg_utilization: float
    dram_bytes: float


def _tile_candidates(total: float, par: float) -> list[float]:
    """Tile sizes: multiples of the parallel dim, plus the full extent."""
    cands = set()
    t = par
    while t < total:
        cands.add(t)
        t *= 2
    cands.add(total)
    return sorted(cands)


def _layer_perf(layer: wl.Layer, cfg: accmod.AcceleratorConfig,
                bytes_per_cycle: float, n_dies: int = 1) -> LayerPerf:
    """One layer on `n_dies` identical dies.  `cfg` describes the FULL
    (rows x cols) array; each die owns cols/n_dies output-channel columns,
    `cfg.glb_kib` of buffer, and one DRAM channel of `cfg.dram_gbps`.  The
    K dimension, weight bytes, and ofmap bytes scale by 1/n_dies per die;
    the ifmap is replicated (and all-gathered over D2D between layers)."""
    rows, cols = cfg.pe_rows, cfg.pe_cols
    glb = cfg.glb_kib * 1024
    if isinstance(layer, wl.GemmLayer):
        c, k, hw = layer.k, layer.n, layer.m  # map GEMM onto the conv nest
        r = s = 1
        ifm, wgt, ofm = layer.ifmap_bytes, layer.weight_bytes, layer.ofmap_bytes
    else:
        c, k, hw = layer.c_in, layer.c_out, layer.h_out * layer.w_out
        r, s = layer.r, layer.s
        ifm, wgt, ofm = layer.ifmap_bytes, layer.weight_bytes, layer.ofmap_bytes

    # per-die view: K-partitioned output channels on a cols/n sub-array
    cols_d = cols / n_dies
    k_d = k / n_dies
    wgt_d = wgt / n_dies
    ofm_d = ofm / n_dies
    compute = hw * r * s * math.ceil(c / rows) * math.ceil(k_d / cols_d)
    util = (layer.macs / n_dies) / (compute * rows * cols_d)

    # --- DRAM traffic: best (loop order x tiling) under GLB capacity -------
    best = float("inf")
    for tk in _tile_candidates(k_d, cols_d):
        for tc in _tile_candidates(c, rows):
            w_tile = tk * tc * r * s
            i_tile = tc * max(1, ifm // max(c, 1))  # per-channel ifmap slice
            if 2 * (w_tile + i_tile) > glb:
                continue
            n_k = math.ceil(k_d / tk)
            n_c = math.ceil(c / tc)
            # weight-stationary: weights once; ifmap streamed per K tile
            ws = wgt_d + ifm * n_k + ofm_d * max(1, n_c)
            # ifmap-stationary: ifmap once; weights streamed per C tile pass
            is_ = ifm + wgt_d * 1 + ofm_d * max(1, n_c)  # weights fit pass-wise
            # ifmap-stationary only valid if a full K-slice of weights tiles
            # through GLB while the ifmap tile persists:
            if 2 * w_tile + i_tile <= glb:
                best = min(best, ws, is_)
            else:
                best = min(best, ws)
    if best == float("inf"):
        # degenerate: stream everything per smallest tile
        best = wgt_d * math.ceil(hw / 64) + ifm * math.ceil(k_d / cols_d) \
            + ofm_d * 2
    mem_cycles = best / bytes_per_cycle
    d2d_cycles = hop = 0.0
    if n_dies > 1:
        # D2D bytes/cycle at the same clock as the DRAM bytes/cycle
        d2d_bpc = bytes_per_cycle * (D2D_GBPS / cfg.dram_gbps)
        d2d_cycles = ifm * (n_dies - 1) / n_dies / d2d_bpc
        hop = D2D_HOP_CYCLES
    return LayerPerf(layer.name, float(compute), float(mem_cycles),
                     float(best), float(util), float(d2d_cycles), float(hop))


def layers_perf(layers: list[wl.Layer], cfg: accmod.AcceleratorConfig,
                n_dies: int = 1) -> WorkloadPerf:
    """Perf of an explicit layer list (uncached): the calibration bridge
    uses this to evaluate ad-hoc workloads built from a served model's
    actual dimensions rather than a registered workload name."""
    freq = carbonmod.node_frequency(cfg.node_nm)
    bytes_per_cycle = cfg.dram_gbps * 1e9 / freq
    perfs = tuple(_layer_perf(l, cfg, bytes_per_cycle, n_dies)
                  for l in layers)
    total = sum(p.cycles for p in perfs)
    fps = freq / total
    avg_util = sum(p.utilization * p.compute_cycles for p in perfs) / \
        max(sum(p.compute_cycles for p in perfs), 1e-9)
    return WorkloadPerf(perfs, total, fps, avg_util,
                        sum(p.dram_bytes for p in perfs))


@functools.lru_cache(maxsize=4096)
def _workload_perf_cached(workload: str, cfg_key: tuple,
                          n_dies: int) -> WorkloadPerf:
    cfg = accmod.AcceleratorConfig(*cfg_key)
    return layers_perf(wl.WORKLOADS[workload](), cfg, n_dies)


def workload_perf(workload: str, cfg: accmod.AcceleratorConfig,
                  n_dies: int = 1) -> WorkloadPerf:
    key = (cfg.pe_rows, cfg.pe_cols, cfg.rf_bytes_per_pe, cfg.glb_kib,
           cfg.multiplier, cfg.node_nm, cfg.dram_gbps)
    return _workload_perf_cached(workload, key, n_dies)


def fps(workload: str, cfg: accmod.AcceleratorConfig,
        n_dies: int = 1) -> float:
    return workload_perf(workload, cfg, n_dies).fps


# ---------------------------------------------------------------------------
# Batched tensor form: the same loop-nest model as `_layer_perf`, expressed
# as float32 tensor math broadcast over (batch of configs) x (layer table)
# x (tile-candidate grid) — the population-parallel evaluator behind
# `core/ga_batched.py`, on the device of the caller's choosing.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LayerTable:
    """Struct-of-arrays layer description, one row per layer."""
    c: np.ndarray        # input channels (GEMM: K)
    k: np.ndarray        # output channels (GEMM: N)
    hw: np.ndarray       # output spatial positions (GEMM: M)
    rs: np.ndarray       # filter taps r*s (GEMM: 1)
    i_per_c: np.ndarray  # per-channel ifmap slice bytes, max(1, ifm//c)
    ifm: np.ndarray      # ifmap bytes
    wgt: np.ndarray      # weight bytes
    ofm: np.ndarray      # ofmap bytes


def layer_table(layers: list[wl.Layer]) -> LayerTable:
    rows = []
    for l in layers:
        if isinstance(l, wl.GemmLayer):
            c, k, hw, rs = l.k, l.n, l.m, 1
        else:
            c, k, hw, rs = l.c_in, l.c_out, l.h_out * l.w_out, l.r * l.s
        rows.append((c, k, hw, rs, max(1, l.ifmap_bytes // max(c, 1)),
                     l.ifmap_bytes, l.weight_bytes, l.ofmap_bytes))
    arr = np.asarray(rows, dtype=np.float32).T
    return LayerTable(*arr)


@functools.lru_cache(maxsize=32)
def workload_table(workload: str) -> LayerTable:
    return layer_table(wl.WORKLOADS[workload]())


# Tile candidates are {par * 2^j clamped at the full extent}; 15 levels
# cover every extent in WORKLOADS from the smallest parallel dim (4).
_TILE_LEVELS = 15

#: Bytes the largest (configs, layers, Jc, Jk) float32 intermediate of
#: `batched_fps` may take; the config batch is cut into chunks to fit.
#: One chunk holds about 1,900 ResNet152 configs (155 layers), so
#: `build_space`'s 270-config lattice never splits; the bound is for a
#: caller that passes a finer lattice or a population's own configs.
CHUNK_BYTES = 256 << 20


def _configs_cycles(rows, cols, glb_bytes, dies, bpc, d2d_bpc, t: dict):
    """Total cycles of each config in a batch over every layer of the
    table: `rows/cols/glb_bytes/dies` are (B,) float32 tensors and `t`
    the layer table's float32 columns on the same device.  Mirrors
    `_layer_perf` exactly, including the per-die K partition (k/dies
    output channels on cols/dies columns per die, weight/ofmap bytes
    scaled, ifmap replicated + all-gathered over D2D).  Axes: config B,
    layer L, C-tile level Jc, K-tile level Jk."""
    rows, cols = rows[:, None], cols[:, None]                 # (B, 1)
    glb_bytes, dies = glb_bytes[:, None], dies[:, None]
    c, hw, rs, ifm = t["c"], t["hw"], t["rs"], t["ifm"]       # (L,)
    cols_d = cols / dies                                      # (B, 1)
    k_d = t["k"] / dies                                       # (B, L)
    wgt_d = t["wgt"] / dies
    ofm_d = t["ofm"] / dies
    compute = hw * rs * torch.ceil(c / rows) * torch.ceil(k_d / cols_d)

    lvl = t["lvl"]                                            # (J,)
    tk = torch.minimum(cols_d[..., None] * lvl, k_d[..., None])  # (B, L, J)
    tc = torch.minimum(rows[..., None] * lvl, c[:, None])         # (B, L, J)
    w_tile = tc[..., :, None] * tk[..., None, :] * rs[:, None, None]
    i_tile = (tc * t["i_per_c"][:, None])[..., None]          # (B, L, Jc, 1)
    n_k = torch.ceil(k_d[..., None] / tk)[..., None, :]       # (B, L, 1, Jk)
    n_c = torch.ceil(c[:, None] / tc)[..., None]              # (B, L, Jc, 1)
    wgt_e, ofm_e = wgt_d[..., None, None], ofm_d[..., None, None]
    ifm_e = ifm[:, None, None]
    ws = wgt_e + ifm_e * n_k + ofm_e * n_c
    is_ = ifm_e + wgt_e + ofm_e * n_c
    glb_e = glb_bytes[..., None, None]
    feasible = 2.0 * (w_tile + i_tile) <= glb_e
    is_valid = 2.0 * w_tile + i_tile <= glb_e
    cand = torch.where(feasible,
                       torch.where(is_valid, torch.minimum(ws, is_), ws),
                       torch.inf)
    best = torch.amin(cand, dim=(2, 3))                       # (B, L)
    fallback = (wgt_d * torch.ceil(hw / 64.0)
                + ifm * torch.ceil(k_d / cols_d) + ofm_d * 2.0)
    best = torch.where(torch.isinf(best), fallback, best)
    multi = dies > 1
    d2d = torch.where(multi, ifm * (dies - 1.0) / dies / d2d_bpc, 0.0)
    hop = torch.where(multi, D2D_HOP_CYCLES, 0.0)
    per_layer = torch.maximum(torch.maximum(compute, best / bpc), d2d) + hop
    return torch.sum(per_layer, dim=1)


def batched_fps(workload: str, rows, cols, glb_kib, node_nm: int,
                dram_gbps: float = 19.2, dies=None,
                device: str | torch.device | None = None) -> torch.Tensor:
    """FPS for a whole batch of (pe_rows, pe_cols, glb_kib[, n_dies])
    configs at once, as a float32 tensor on `device` (default: the CUDA
    device).  Matches `workload_perf(...).fps` to f32 rounding (the numpy
    reference computes the identical candidate set in f64).  The batch
    runs in chunks that keep each (configs, layers, Jc, Jk) intermediate
    within `CHUNK_BYTES`."""
    from repro_torch.device import resolve_device
    dev = resolve_device(device)
    lt = workload_table(workload)
    freq = carbonmod.node_frequency(node_nm)
    bpc = dram_gbps * 1e9 / freq
    d2d_bpc = bpc * (D2D_GBPS / dram_gbps)

    def f32(x):
        return torch.tensor(np.asarray(x, np.float32), device=dev)

    t = {f.name: f32(getattr(lt, f.name))
         for f in dataclasses.fields(LayerTable)}
    t["lvl"] = 2.0 ** torch.arange(_TILE_LEVELS, dtype=torch.float32,
                                   device=dev)
    rows = f32(rows).reshape(-1)
    cols, glb = f32(cols).reshape(-1), f32(glb_kib).reshape(-1) * 1024.0
    dies = torch.ones_like(rows) if dies is None else f32(dies).reshape(-1)
    step = max(1, CHUNK_BYTES // (4 * len(lt.c) * _TILE_LEVELS ** 2))
    total = torch.cat([
        _configs_cycles(rows[i:i + step], cols[i:i + step],
                        glb[i:i + step], dies[i:i + step], bpc, d2d_bpc, t)
        for i in range(0, len(rows), step)])
    return freq / total
