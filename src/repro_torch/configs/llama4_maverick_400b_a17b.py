"""Llama4-Maverick-400B-A17B — 128 routed experts top-1, MoE on alternating
layers with a shared expert, dense interleave FFN 2x wider
[hf:meta-llama/Llama-4 family; unverified].  With these settings the config
lands at ~402B total / ~18B active parameters, matching the nameplate."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b", family="lm",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=8192,
    vocab=202048, head_dim=128, rope_theta=500000.0,
    n_experts=128, top_k=1, moe_every=2, d_ff_dense=16384,
    shared_expert=True,
)
