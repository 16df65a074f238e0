"""PyTorch + CUDA port of the GK Select exact quantile (the JAX package
``repro`` is the reference it is held against, and it imports nothing of it).

core     the single-device engines: GK Select (sample sketch -> pivot -> one
         fused count+extract round over all shards -> resolve) and grouped
         GK Select (segmented sketch -> per-group pivots -> one segmented
         round -> resolve); and the sharded engine over torch.distributed,
         each rank holding one shard (``distributed_quantile(_multi)``,
         ``distributed_quantile_grouped``)
kernels  the Hopper kernels, their plain PyTorch versions, the device
         dispatch between them, and the counting and radix-select entry
         points

Entry points run where their tensor lives; those that take host data take
``device=`` (default ``"cuda"``, which raises without a card).
"""
from . import checkpoint, core, kernels, launch
from .core import (exact_quantile, exact_quantile_rank, gk_select,
                   gk_select_multi, gk_select_grouped, full_sort_quantile,
                   approx_quantile, distributed_quantile,
                   distributed_quantile_multi, distributed_quantile_grouped)
from .launch import QuantileService, Window
from .checkpoint import save_service_snapshot, restore_service_snapshot

__all__ = ["checkpoint", "core", "kernels", "launch", "exact_quantile",
           "exact_quantile_rank", "gk_select", "gk_select_multi", "gk_select_grouped",
           "full_sort_quantile", "approx_quantile", "distributed_quantile",
           "distributed_quantile_multi", "distributed_quantile_grouped",
           "QuantileService", "Window", "save_service_snapshot",
           "restore_service_snapshot"]
