"""falcon-mamba-7b — attention-free Mamba1 stack [arXiv:2410.05355]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=65024,
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    ssm_chunk=256,
    tie_embeddings=True,
    source="arXiv:2410.05355",
)
