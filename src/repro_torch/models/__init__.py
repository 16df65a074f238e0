"""Model stack of the port: config, layers, the routed experts, and the
assembly of the dense, vlm and moe families (init, the weights of a JAX
checkpoint, the training loss, prefill, decode)."""
from .config import ModelConfig
from . import layers, model, moe

__all__ = ["ModelConfig", "layers", "model", "moe"]
