"""recurrentgemma-2b — RG-LRU + local attention hybrid, pattern 2 recurrent :
1 local-attn [arXiv:2402.19427]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_ff=7680,
    vocab_size=256000,
    head_dim=256,
    rnn_width=2560,
    local_window=2048,
    block_pattern=("rec", "rec", "attn"),
    rope_theta=10_000.0,
    source="arXiv:2402.19427",
)
