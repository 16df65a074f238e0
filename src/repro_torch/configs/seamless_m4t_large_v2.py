"""SeamlessM4T-large v2 — enc-dec multimodal (audio frontend stubbed with
precomputed frame embeddings) [arXiv:2308.11596]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_head=64,
    d_ff=8192, vocab=256206,
    enc_layers=24, enc_seq_divisor=4,
    modality="audio_stub", mlp_type="gelu",
)
