"""arctic-480b — MoE 128 experts top-2 + dense residual [hf:Snowflake/snowflake-arctic-base]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    head_dim=128,
    n_experts=128,
    top_k=2,
    moe_dense_residual=True,  # dense MLP residual in parallel with the MoE FFN
    rope_theta=10_000.0,
    source="hf:Snowflake/snowflake-arctic-base",
)
