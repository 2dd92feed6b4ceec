"""Llama-3.2-Vision-11B — cross-attn image layers every 5th decoder layer;
patch frontend is a stub (input_specs supplies patch embeddings)
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b", family="lm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=128256, head_dim=128, rope_theta=500000.0,
    cross_every=5, n_img_tokens=1600,
)
