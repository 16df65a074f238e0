"""DeepSeek-Coder 33B — 62L dense llama-arch GQA [arXiv:2401.14196]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b", family="dense",
    n_layers=62, d_model=7168, n_heads=56, n_kv_heads=8, d_head=128,
    d_ff=19200, vocab=32256, mlp_type="swiglu",
)
