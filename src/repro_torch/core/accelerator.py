"""NVDLA-style accelerator configuration and silicon area model.

The design space follows the paper's evaluation setup: MAC arrays from 64 to
2048 PEs in powers of two, with local (per-PE accumulator/register-file) and
global (convolution buffer) SRAM scaling with the array, as in the NVDLA
primer.  Area is composed from:

  * MAC datapath: the (possibly approximate) 8x8 multiplier netlist area +
    a 32-bit accumulator adder + pipeline registers (NAND2-equivalents),
  * SRAM macros (um^2/bit per node, incl. periphery),
  * a fixed-fraction NoC/control/IO overhead.

The multiplier area is the *paper's lever*: swapping the exact multiplier for
a pruned/truncated one shrinks every MAC, which shrinks the die, which
shrinks embodied carbon (and frees area for memory at iso-carbon).
"""

from __future__ import annotations

import dataclasses

import torch

from . import multipliers as mm
from . import netlist as nlmod

# Non-multiplier MAC datapath cost, NAND2-equivalents:
# 32-bit accumulator adder (~32 full adders @ ~9.65) + 16-bit operand /
# pipeline registers (~24 flops @ 4.5) + mux/control (~40).
MAC_OVERHEAD_NAND2EQ = 32 * 9.65 + 24 * 4.5 + 40.0

# SRAM area per *bit*, including periphery [um^2/bit] (public ballpark:
# high-density 6T bitcell x ~1.6 periphery factor).
SRAM_UM2_PER_BIT = {7: 0.045, 14: 0.11, 28: 0.30}

# NoC + control + IO + PLL overhead as a fraction of (MAC + SRAM) area.
OVERHEAD_FRACTION = 0.18

VALID_PE_COUNTS = (64, 128, 256, 512, 1024, 2048)


@dataclasses.dataclass(frozen=True)
class AcceleratorConfig:
    """A point in the paper's design space."""
    pe_rows: int            # input-channel parallelism (NVDLA Atomic-C)
    pe_cols: int            # output-channel parallelism (NVDLA Atomic-K)
    rf_bytes_per_pe: int    # per-PE accumulator/register file
    glb_kib: int            # global convolution buffer (CBUF)
    multiplier: str         # name in the multiplier library / Pareto front
    node_nm: int
    dram_gbps: float = 19.2  # LPDDR4x-class edge memory system

    @property
    def num_pes(self) -> int:
        return self.pe_rows * self.pe_cols

    def validate(self) -> None:
        if self.num_pes not in VALID_PE_COUNTS:
            raise ValueError(f"PE count {self.num_pes} not in {VALID_PE_COUNTS}")
        if self.node_nm not in SRAM_UM2_PER_BIT:
            raise ValueError(f"node {self.node_nm}nm unsupported")


def nvdla_default(num_pes: int, node_nm: int, multiplier: str = "exact"
                  ) -> AcceleratorConfig:
    """NVDLA-primer-style scaling: CBUF and RF scale with the MAC array
    (full NVDLA: 2048 MACs / 512 KiB CBUF -> 256 B per MAC)."""
    rows = 1
    while rows * rows < num_pes:
        rows *= 2
    cols = num_pes // rows
    return AcceleratorConfig(
        pe_rows=rows, pe_cols=cols,
        rf_bytes_per_pe=32,
        glb_kib=max(64, (num_pes * 256) // 1024),
        multiplier=multiplier, node_nm=node_nm)


@dataclasses.dataclass(frozen=True)
class AreaBreakdown:
    mult_mm2: float
    mac_other_mm2: float
    rf_mm2: float
    glb_mm2: float
    overhead_mm2: float
    total_mm2: float

    @property
    def mult_fraction(self) -> float:
        return self.mult_mm2 / self.total_mm2


def _area_components_um2(num_pes: float, rf_bytes_per_pe: float,
                         glb_kib: float, mult_area_nand2eq: float,
                         node_nm: int) -> tuple[float, float, float, float]:
    """(mult, mac_other, rf, glb) [um^2] — the ONE scalar source of the
    area formula (area_total_mm2_arr is its tensor twin)."""
    nand2_um2 = nlmod.NAND2_UM2[node_nm]
    sram_um2_bit = SRAM_UM2_PER_BIT[node_nm]
    return (mult_area_nand2eq * nand2_um2 * num_pes,
            MAC_OVERHEAD_NAND2EQ * nand2_um2 * num_pes,
            rf_bytes_per_pe * 8 * sram_um2_bit * num_pes,
            glb_kib * 1024 * 8 * sram_um2_bit)


def area_model(cfg: AcceleratorConfig) -> AreaBreakdown:
    cfg.validate()
    mult = mm.get_multiplier(cfg.multiplier)
    mult_um2, mac_other_um2, rf_um2, glb_um2 = _area_components_um2(
        cfg.num_pes, cfg.rf_bytes_per_pe, cfg.glb_kib, mult.area_nand2eq,
        cfg.node_nm)
    core = mult_um2 + mac_other_um2 + rf_um2 + glb_um2
    overhead_um2 = OVERHEAD_FRACTION * core
    to_mm2 = 1e-6
    return AreaBreakdown(
        mult_mm2=mult_um2 * to_mm2,
        mac_other_mm2=mac_other_um2 * to_mm2,
        rf_mm2=rf_um2 * to_mm2,
        glb_mm2=glb_um2 * to_mm2,
        overhead_mm2=overhead_um2 * to_mm2,
        total_mm2=(core + overhead_um2) * to_mm2,
    )


def die_area_mm2(cfg: AcceleratorConfig, n_dies: int = 1) -> float:
    """Area of ONE die of an `n_dies`-way split of `cfg`: num_pes/n MACs
    plus the per-die buffers (`cfg.rf_bytes_per_pe` per PE, `cfg.glb_kib`
    per die).  `n_dies == 1` equals `area_model(cfg).total_mm2` exactly.
    Unvalidated on purpose — the GA scores infeasible die splits (to mask
    them) where num_pes/n falls outside VALID_PE_COUNTS."""
    mult = mm.get_multiplier(cfg.multiplier)
    core = sum(_area_components_um2(
        cfg.num_pes / n_dies, cfg.rf_bytes_per_pe, cfg.glb_kib,
        mult.area_nand2eq, cfg.node_nm))
    return core * (1.0 + OVERHEAD_FRACTION) * 1e-6


def area_total_mm2_arr(num_pes: torch.Tensor, rf_bytes_per_pe: torch.Tensor,
                       glb_kib: torch.Tensor, mult_area_nand2eq: torch.Tensor,
                       node_nm: int) -> torch.Tensor:
    """`area_model(...).total_mm2` as a pure elementwise tensor function —
    the population-parallel form used inside the batched GA step, on the
    operands' device.  Inputs are same-shaped float32 tensors of physical
    quantities (the batched GA gathers them from its genome index
    tables)."""
    nand2_um2 = nlmod.NAND2_UM2[node_nm]
    sram_um2_bit = SRAM_UM2_PER_BIT[node_nm]
    mult_um2 = mult_area_nand2eq * nand2_um2 * num_pes
    mac_other_um2 = MAC_OVERHEAD_NAND2EQ * nand2_um2 * num_pes
    rf_um2 = rf_bytes_per_pe * 8.0 * sram_um2_bit * num_pes
    glb_um2 = glb_kib * 1024.0 * 8.0 * sram_um2_bit
    core = mult_um2 + mac_other_um2 + rf_um2 + glb_um2
    return core * (1.0 + OVERHEAD_FRACTION) * 1e-6
