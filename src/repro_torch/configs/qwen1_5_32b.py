"""Qwen1.5-32B — QKV bias [hf:Qwen/Qwen1.5 family; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b", family="lm",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=40, d_ff=27392,
    vocab=152064, head_dim=128, qkv_bias=True, rope_theta=1000000.0,
)
