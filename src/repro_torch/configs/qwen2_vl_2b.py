"""Qwen2-VL 2B — 28L VLM backbone with M-RoPE; vision frontend is a stub
(input_specs feeds precomputed patch embeddings) [arXiv:2409.12191]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b", family="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, d_head=128,
    d_ff=8960, vocab=151936,
    mrope=True, mrope_sections=(16, 24, 24),
    modality="vision_stub", frontend_len=256, mlp_type="swiglu",
)
