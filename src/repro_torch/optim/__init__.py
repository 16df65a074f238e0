"""Optimizer substrate of the port: AdamW and the paper's exact-quantile
primitives over pytrees and channels (deterministic clipping,
quantile-scaled int8 gradient compression, per-channel scales)."""
from .adamw import (AdamWConfig, AdamWState, adamw_init, adamw_update,
                    compress_int8, decompress_int8)
from .quantile_ops import (channelwise_exact_quantile, pytree_exact_quantile,
                           pytree_radix_quantile, quantile_clip_by_value)

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "adamw_update",
           "compress_int8", "decompress_int8", "pytree_exact_quantile",
           "pytree_radix_quantile", "channelwise_exact_quantile",
           "quantile_clip_by_value"]
