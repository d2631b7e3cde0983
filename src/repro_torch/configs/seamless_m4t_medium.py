"""seamless-m4t-medium — encoder/decoder transformer backbone, multimodal
frontend stubbed as precomputed frame embeddings [arXiv:2308.11596]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,  # decoder layers
    n_enc_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    head_dim=64,
    enc_len_train=4096,
    enc_len_serve=4096,
    rope_theta=10_000.0,
    source="arXiv:2308.11596",
)
