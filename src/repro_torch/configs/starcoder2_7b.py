"""StarCoder2-7B — GQA, RoPE [arXiv:2402.19173; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b", family="lm",
    n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4, d_ff=18432,
    vocab=49152, head_dim=128, rope_theta=1000000.0, mlp_style="gelu",
)
