"""IBM Granite 8B (code) — 36L dense llama-arch GQA [arXiv:2405.04324]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=14336, vocab=49152, mlp_type="swiglu",
)
