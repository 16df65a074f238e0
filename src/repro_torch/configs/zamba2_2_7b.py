"""Zamba2 2.7B — 54L Mamba2 backbone + shared attention block every 6 layers
[arXiv:2411.15242]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, d_head=80,
    d_ff=10240, vocab=32000,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, hybrid_attn_every=6,
    mlp_type="swiglu",
)
