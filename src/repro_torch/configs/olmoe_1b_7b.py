"""OLMoE-1B-7B — 16L MoE, 64 experts top-8 [arXiv:2409.02060]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, d_head=128,
    d_ff=1024, vocab=50304,
    moe_experts=64, moe_top_k=8, mlp_type="swiglu",
)
