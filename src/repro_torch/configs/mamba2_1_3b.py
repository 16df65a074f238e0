"""Mamba2 1.3B — 48L pure SSD (state-space duality), attention-free
[arXiv:2405.21060]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=0, n_kv_heads=0, d_head=0,
    d_ff=0, vocab=50280,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64,
)
