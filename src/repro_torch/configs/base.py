"""Config schema: model architecture, input shapes and run options."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # "lm" | "ssm" | "hybrid" | "encdec"
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 1e4
    tie_embeddings: bool = False
    mlp_style: str = "swiglu"   # "swiglu" (3-matrix) | "gelu" (2-matrix)
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_every: int = 1          # 1 = every layer MoE; 2 = alternating
    d_ff_dense: int = 0         # dense-interleave FFN width (0 -> d_ff)
    shared_expert: bool = False
    # SSM (mamba2 / SSD)
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_width: int = 4
    ssd_chunk: int = 256
    # hybrid (recurrentgemma: RG-LRU + local attention, pattern 2:1)
    window: int = 0
    lru_width: int = 0
    # encoder-decoder (whisper: conv frontend is a stub; encoder consumes
    # precomputed frame embeddings per the brief)
    n_enc_layers: int = 0
    enc_seq: int = 0
    # vision-language (llama-3.2-vision: patch frontend is a stub; cross
    # attention blocks every `cross_every` decoder layers)
    n_img_tokens: int = 0
    cross_every: int = 0
    # numerics / execution
    dtype: str = "bfloat16"
    mult: str = "exact"         # approximate-multiplier library name
    kernel_policy: str = "auto"  # "auto" | "pallas" | "xla" (kernels/dispatch)
    attn_impl: str = "chunked"  # "naive" | "chunked" | "flash"
    attn_chunk: int = 512
    remat: bool = True
    # technique applicability (see DESIGN.md §Arch-applicability)
    notes: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def param_count(self) -> int:
        """Total parameters N (for 6*N*D model-flops accounting)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        hd = self.hd
        if self.family == "ssm":
            d_in = self.ssm_expand * d
            per = (d * (2 * d_in + 2 * self.ssm_heads * 0)  # in_proj core
                   + d * (2 * self.ssm_state * 1)           # B, C proj
                   + d * self.ssm_heads                      # dt proj
                   + d_in * d                                # out proj
                   + 2 * d)                                  # norms
            return self.n_layers * per + 2 * v * d
        att = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
            + (self.n_heads * hd) * d
        nmat = 3 if self.mlp_style == "swiglu" else 2
        if self.is_moe:
            n_moe = self.n_layers // self.moe_every
            n_dense = self.n_layers - n_moe
            fd = self.d_ff_dense or f
            mlp_total = n_moe * (self.n_experts * 3 * d * f
                                 + d * self.n_experts
                                 + (3 * d * f if self.shared_expert else 0))
            mlp_total += n_dense * nmat * d * fd
        else:
            mlp_total = self.n_layers * nmat * d * f
        total = self.n_layers * (att + 2 * d) + mlp_total
        total += (1 if self.tie_embeddings else 2) * v * d
        if self.cross_every:
            n_cross = self.n_layers // self.cross_every
            total += n_cross * (2 * att + d)
        if self.n_enc_layers:
            total += self.n_enc_layers * (att + nmat * d * f + 2 * d)
        return total

    def active_param_count(self) -> int:
        """N_active for MoE (6*N_active*D in the roofline MODEL_FLOPS)."""
        if not self.is_moe:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        hd = self.hd
        att = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
            + (self.n_heads * hd) * d
        n_moe = self.n_layers // self.moe_every
        n_dense = self.n_layers - n_moe
        fd = self.d_ff_dense or f
        mlp_total = n_moe * (self.top_k * 3 * d * f + d * self.n_experts
                             + (3 * d * f if self.shared_expert else 0))
        mlp_total += n_dense * 3 * d * fd
        return self.n_layers * (att + 2 * d) + mlp_total + 2 * self.vocab * d


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One (input-shape) cell of the evaluation matrix."""
    name: str                   # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                   # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests."""
    small: dict = dict(
        n_layers=min(cfg.n_layers, 2 if not cfg.cross_every else 4),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads
        else 4,
        d_ff=256,
        vocab=512,
        head_dim=32,
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        d_ff_dense=256 if cfg.d_ff_dense else 0,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_heads=min(cfg.ssm_heads, 4) if cfg.ssm_heads else 0,
        ssm_head_dim=16 if cfg.ssm_heads else 64,
        window=min(cfg.window, 32) if cfg.window else 0,
        lru_width=128 if cfg.lru_width else 0,
        n_enc_layers=min(cfg.n_enc_layers, 2),
        enc_seq=min(cfg.enc_seq, 16) if cfg.enc_seq else 0,
        n_img_tokens=min(cfg.n_img_tokens, 16) if cfg.n_img_tokens else 0,
        cross_every=2 if cfg.cross_every else 0,
        dtype="float32",
        attn_chunk=16,
        remat=False,
    )
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
