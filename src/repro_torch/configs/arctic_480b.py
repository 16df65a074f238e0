"""Snowflake Arctic 480B — 35L, MoE 128e top-2 + dense residual
[hf:Snowflake/snowflake-arctic-base]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8, d_head=128,
    d_ff=4864, vocab=32000,
    moe_experts=128, moe_top_k=2, moe_dense_residual=True, mlp_type="swiglu",
)
