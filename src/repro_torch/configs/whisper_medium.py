"""Whisper-medium — enc-dec, conv frontend stubbed (frame embeddings in)
[arXiv:2212.04356; unverified]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="encdec",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=4096,
    vocab=51865, head_dim=64,
    n_enc_layers=24, enc_seq=1500, mlp_style="gelu", tie_embeddings=True,
)
