"""Model stack of the port: config, layers, the routed experts, the
Mamba-2 (SSD) block, and the assembly of the dense, vlm, moe, ssm, hybrid
and encoder-decoder (audio) families (init, the weights of a JAX
checkpoint, the training loss, prefill, decode)."""
from .config import ModelConfig
from . import layers, model, moe, ssm

__all__ = ["ModelConfig", "layers", "model", "moe", "ssm"]
