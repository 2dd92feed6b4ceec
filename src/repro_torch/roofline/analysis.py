"""Roofline model of the port on the card.

Two uses, one set of hardware numbers (`Chip`, data-sheet peaks):

  kernel bound  = max(compulsory bytes / HBM rate,
                      operations / peak rate of the operand type)
                  (`kernel_bound`): the least time the card could take
                  for a kernel's work, each input byte read once and each
                  output byte written once, whatever the kernel re-reads;
  cell terms    = flops / (chips x peak), bytes / (chips x HBM rate),
                  collective bytes / (chips x link rate)
                  (`RooflineTerms` and the analytic cell functions).

`H100_SXM` is the default chip; `V5E` carries the JAX package's TPU
constants, so that tests can hold the cell formulas to that package's.

Not ported: the JAX package's GEMM path-cost model (`gemm_path_cost`,
`predicted_gemm_winner`): dispatch takes a measured plan or the static
one, and the tuner times every candidate, so nothing here ranks plans.
Its `parse_collectives`, `terms_from_compiled` and `memory_summary` (and
`roofline/hlo_parse.py`, `report.py`) read XLA's compiled HLO; they wait
for a dry-run launcher of the port.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Chip:
    """One device's peaks (dense rates)."""
    name: str
    hbm_bytes_per_s: float
    peak_int8: float            # int8 tensor-core (MXU) ops/s
    peak_bf16: float            # bf16 tensor-core (MXU) flop/s
    peak_f32: float             # f32 flop/s
    link_bytes_per_s: float     # one direction of one link

    def peak(self, dtype: str) -> float:
        return {"int8": self.peak_int8, "bf16": self.peak_bf16,
                "f32": self.peak_f32}[dtype]


#: NVIDIA's H100 SXM data sheet (dense, at the 700 W limit): 3.35 TB/s of
#: HBM3, 1,979 TOP/s int8, 989 TFLOP/s bf16, 67 TFLOP/s f32 (tensor
#: cores), NVLink 450 GB/s each way.
H100_SXM = Chip("H100 SXM", 3.35e12, 1979e12, 989e12, 67e12, 450e9)
#: The JAX package's TPU v5e-class constants (`roofline/analysis.py`):
#: 197 TFLOP/s bf16, int8 at twice that, 819 GB/s of HBM, 50 GB/s ICI
#: links; f32 is rated at the bf16 peak, as that package's cell terms
#: rate every flop.
V5E = Chip("TPU v5e", 819e9, 2 * 197e12, 197e12, 197e12, 50e9)

KERNELS = ("quantize_rows", "flash_attention", "approx_qgemm_plane0",
           "approx_qgemm_skinny", "approx_qgemm_fused", "approx_qgemm_stacked")


# ---------------------------------------------------------------------------
# kernel bounds
# ---------------------------------------------------------------------------

def _causal_pairs(sq: int, skv: int) -> int:
    """(query, key) pairs of causal attention, queries aligned to the end
    of the keys: query i sees skv - sq + i + 1 of them."""
    return sum(min(max(skv - sq + i + 1, 0), skv) for i in range(sq))


def kernel_work(kernel: str, shapes) -> tuple[float, float, str]:
    """(compulsory bytes, operations, operand type) of one call of
    `kernel` per shape in `shapes`:

      quantize_rows         (m, k): f32 rows in, int8 codes and f32 row
                            scales out; 4 operations an element;
      approx_qgemm_plane0 / _skinny / _fused
                            (m, k, n) or (m, k, n, planes): int8 A and B
                            raw, f32 out, at planes > 1 the (R, 256) int8
                            tables of both operands and R + 1 f32 scales;
                            2 m k n int8 operations a plane;
      approx_qgemm_stacked  (m, k, n, planes): the pre-mapped stacks of
                            both operands, P f32 scales, f32 out;
      flash_attention       (bh, sq, skv, d[, causal[, itemsize]]): q, k,
                            v in, o out; 4 d operations a (query, key)
                            pair (two products), f32 or bf16 by itemsize.
    """
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}; expected one of "
                         f"{KERNELS}")
    nbytes = ops = 0.0
    dtype = "int8"
    for shape in shapes:
        if kernel == "quantize_rows":
            m, k = shape
            nbytes += 5 * m * k + 4 * m
            ops += 4 * m * k
            dtype = "f32"
        elif kernel == "flash_attention":
            bh, sq, skv, d, *rest = shape
            causal = rest[0] if rest else True
            itemsize = rest[1] if len(rest) > 1 else 4
            nbytes += 2 * bh * (sq + skv) * d * itemsize
            pairs = _causal_pairs(sq, skv) if causal else sq * skv
            ops += 4 * d * pairs * bh
            dtype = "f32" if itemsize == 4 else "bf16"
        else:
            m, k, n, planes = (*shape, 1)[:4]
            if kernel == "approx_qgemm_stacked":
                nbytes += planes * (m * k + k * n) + 4 * m * n + 4 * planes
            else:
                nbytes += m * k + k * n + 4 * m * n
                if planes > 1:
                    nbytes += 2 * 256 * (planes - 1) + 4 * planes
            ops += 2 * m * k * n * planes
    return nbytes, ops, dtype


def kernel_bound(kernel: str, shapes, chip: Chip = H100_SXM
                 ) -> tuple[float, str]:
    """(the least seconds `chip` could take for `kernel_work`, "bytes" or
    "operations": which of the two bounds it)."""
    nbytes, ops, dtype = kernel_work(kernel, shapes)
    tb = nbytes / chip.hbm_bytes_per_s
    to = ops / chip.peak(dtype)
    return (tb, "bytes") if tb >= to else (to, "operations")


# ---------------------------------------------------------------------------
# cell terms (the JAX package's analytic half)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RooflineTerms:
    flops: float                   # whole-program flops
    hbm_bytes: float               # whole-program bytes accessed
    collective_bytes: float        # summed collective operand bytes
    collectives: dict              # per-kind bytes
    chips: int
    model_flops: float             # 6*N*D (or inference analogue)
    # kernel deployment model: traffic of scopes that a kernel keeps
    # on-chip, and the kernel's true HBM I/O to swap in instead
    tagged_bytes: float = 0.0
    kernel_io_bytes: float = 0.0
    chip: Chip = H100_SXM

    @property
    def compute_s(self) -> float:
        return self.flops / (self.chips * self.chip.peak_bf16)

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / (self.chips * self.chip.hbm_bytes_per_s)

    @property
    def hbm_bytes_kernel_adj(self) -> float:
        """HBM bytes with tagged scopes replaced by the kernels' I/O."""
        return max(self.hbm_bytes - self.tagged_bytes, 0.0) + \
            self.kernel_io_bytes

    @property
    def memory_kernel_adj_s(self) -> float:
        return self.hbm_bytes_kernel_adj / (self.chips *
                                            self.chip.hbm_bytes_per_s)

    @property
    def roofline_fraction_kernel_adj(self) -> float:
        ideal = self.model_flops / (self.chips * self.chip.peak_bf16)
        worst = max(self.compute_s, self.memory_kernel_adj_s,
                    self.collective_s)
        return ideal / worst if worst > 0 else 0.0

    @property
    def collective_s(self) -> float:
        return self.collective_bytes / (self.chips *
                                        self.chip.link_bytes_per_s)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / flops: <1 means remat/overhead; >1 means the
        counted program does fewer flops than the analytic model."""
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute fraction of the step's roofline-limited time:
        model_flops/(chips*peak) / max(term)."""
        ideal = self.model_flops / (self.chips * self.chip.peak_bf16)
        worst = max(self.compute_s, self.memory_s, self.collective_s)
        return ideal / worst if worst > 0 else 0.0

    def as_dict(self) -> dict:
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "collective_bytes": self.collective_bytes,
            "collectives": dict(self.collectives), "chips": self.chips,
            "model_flops": self.model_flops,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "tagged_bytes": self.tagged_bytes,
            "kernel_io_bytes": self.kernel_io_bytes,
            "memory_kernel_adj_s": self.memory_kernel_adj_s,
            "roofline_fraction_kernel_adj":
                self.roofline_fraction_kernel_adj,
            "chip": self.chip.name,
        }


def model_flops_for_cell(cfg, shape) -> float:
    """Analytic MODEL_FLOPS for one step of a cell.

    train:   6 * N_active * tokens          (fwd+bwd)
    prefill: 2 * N_active * tokens
    decode:  2 * N_active * batch           (one token per sequence)
    """
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch


def kernel_io_bytes_for_cell(cfg, shape) -> float:
    """Analytic HBM I/O of the attention kernels for one step (q/k/v or
    cache reads + out writes, x passes: fwd / remat / bwd)."""
    if cfg.family == "ssm":
        return 0.0
    b, s = shape.global_batch, shape.seq_len
    hd = cfg.hd
    if cfg.family == "hybrid":
        n_attn = cfg.n_layers // 3
        s_kv = min(s, cfg.window)
    else:
        n_attn = cfg.n_layers + cfg.n_enc_layers
        s_kv = s
    if shape.kind == "decode":
        # decode attention streams the KV cache once per layer
        cache = 2 * b * s_kv * cfg.n_kv_heads * hd * 2
        return n_attn * cache
    qo = b * s * cfg.n_heads * hd * 2
    kv = 2 * b * s * cfg.n_kv_heads * hd * 2
    passes = 4.0 if shape.kind == "train" else 2.0
    return n_attn * passes * (2 * qo + kv)


def analytic_memory_per_device(cfg, shape, mesh_shape: dict,
                               accum: int = 1, fsdp: bool | None = None,
                               moment_bytes: float = 8.0) -> dict:
    """Per-device memory estimate (bytes) of a cell on a mesh of
    `mesh_shape` axes ("pod", "data", "model"): bf16 params, grads and
    optimizer moments, sharded over the model axis (and the data axes
    under FSDP, the default from 20B params), plus the activations, KV or
    recurrent cache and logits of the cell's kind."""
    model_par = mesh_shape.get("model", 1)
    dp = 1
    for ax in ("pod", "data"):
        dp *= mesh_shape.get(ax, 1)
    n = cfg.param_count()
    if fsdp is None:
        fsdp = n >= 20e9
    wshard = model_par * (dp if fsdp else 1)
    params = 2.0 * n / wshard
    grads = 2.0 * n / wshard
    moments = moment_bytes * n / wshard
    out = {"params": params, "grads": 0.0, "opt": 0.0, "activations": 0.0,
           "cache": 0.0, "logits": 0.0}
    if shape.kind == "train":
        mb_local = max(shape.global_batch // dp // accum, 1)
        out["grads"] = grads
        out["opt"] = moments
        out["activations"] = (cfg.n_layers * mb_local * shape.seq_len
                              * cfg.d_model * 2.0)
        out["logits"] = (mb_local * shape.seq_len
                         * max(cfg.vocab // model_par, 1) * 4.0)
    elif shape.kind == "prefill":
        b_local = max(shape.global_batch // dp, 1)
        out["activations"] = (b_local * shape.seq_len * cfg.d_model * 2.0
                              * 4)
        out["cache"] = (cfg.n_layers * b_local * shape.seq_len
                        * cfg.n_kv_heads * cfg.hd * 2 * 2.0)
    else:  # decode
        b_local = max(shape.global_batch // dp, 1)
        if cfg.family == "ssm":
            d_in = cfg.ssm_expand * cfg.d_model
            h = cfg.ssm_heads or 32
            p = d_in // h
            out["cache"] = cfg.n_layers * b_local * (
                h * p * cfg.ssm_state * 4.0 + 3 * (d_in + 2 * cfg.ssm_state))
        elif cfg.family == "hybrid":
            n_attn = cfg.n_layers // 3
            w = cfg.lru_width or cfg.d_model
            out["cache"] = (n_attn * b_local * cfg.window * cfg.n_kv_heads
                            * cfg.hd * 2 * 2.0
                            + cfg.n_layers * b_local * w * 6.0)
        else:
            kvshard = model_par if (cfg.n_kv_heads * cfg.hd) % model_par \
                == 0 else 1
            out["cache"] = (cfg.n_layers * b_local * shape.seq_len
                            * cfg.n_kv_heads * cfg.hd * 2 * 2.0 / kvshard)
    out["total"] = sum(v for k, v in out.items())
    return out
