"""PyTorch + CUDA port of the GK Select exact quantile (the JAX package
``repro`` is the reference it is held against, and it imports nothing of it).

core     the single-device main path: sample sketch -> pivot -> one fused
         count+extract round over all shards -> resolve
kernels  the Hopper kernels of that round, their plain PyTorch versions and
         the device dispatch between them

Entry points run where their tensor lives; those that take host data take
``device=`` (default ``"cuda"``, which raises without a card).
"""
from . import core, kernels
from .core import (exact_quantile, exact_quantile_rank, gk_select,
                   gk_select_multi, full_sort_quantile, approx_quantile)

__all__ = ["core", "kernels", "exact_quantile", "exact_quantile_rank",
           "gk_select", "gk_select_multi", "full_sort_quantile",
           "approx_quantile"]
