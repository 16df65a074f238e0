"""Model stack of the port: config, layers, and the dense family's
assembly (init, the weights of a JAX checkpoint, prefill, decode)."""
from .config import ModelConfig
from . import layers, model

__all__ = ["ModelConfig", "layers", "model"]
