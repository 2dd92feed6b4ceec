"""Grok-1-314B — 8 experts top-2 MoE [hf:xai-org/grok-1; unverified]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b", family="lm",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=32768,
    vocab=131072, head_dim=128,
    n_experts=8, top_k=2,
)
