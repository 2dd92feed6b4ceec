"""RecurrentGemma-9B — RG-LRU + local attention, pattern (rec, rec, attn)
[arXiv:2402.19427; unverified]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, d_ff=12288,
    vocab=256000, head_dim=256, window=2048, lru_width=4096,
)
