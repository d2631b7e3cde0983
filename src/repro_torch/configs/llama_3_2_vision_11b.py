"""llama-3.2-vision-11b — dense GQA transformer with cross-attn image layers
every 5th layer; vision frontend stubbed as precomputed patch embeddings
[hf:meta-llama/Llama-3.2-11B-Vision]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    head_dim=128,
    cross_attn_period=5,  # 8 cross-attn layers over 40
    n_img_tokens=1024,
    rope_theta=500_000.0,
    source="hf:meta-llama/Llama-3.2-11B-Vision",
)
