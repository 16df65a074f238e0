"""Optimizer substrate of the port: the paper's exact-quantile primitives
over pytrees and channels (deterministic clipping, per-channel scales).
``adamw`` waits for the training slice."""
from .quantile_ops import (channelwise_exact_quantile, pytree_exact_quantile,
                           pytree_radix_quantile, quantile_clip_by_value)

__all__ = ["pytree_exact_quantile", "pytree_radix_quantile",
           "channelwise_exact_quantile", "quantile_clip_by_value"]
