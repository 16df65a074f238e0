"""PyTorch + CUDA port of the GK Select exact quantile (the JAX package
``repro`` is the reference it is held against, and it imports nothing of it).

core     the single-device engines: GK Select (sample sketch -> pivot -> one
         fused count+extract round over all shards -> resolve) and grouped
         GK Select (segmented sketch -> per-group pivots -> one segmented
         round -> resolve); the sharded engine over torch.distributed,
         each rank holding one shard (``distributed_quantile(_multi)``,
         ``distributed_quantile_grouped``); and the paper's baselines
         (full sort, PSRS, AFS, Jeffers, the sketch alone)
kernels  the Hopper kernels, their plain PyTorch versions, the device
         dispatch between them, and the counting and radix-select entry
         points
launch   the streaming ``QuantileService``, its ``IngestPool`` and the
         ``StreamingCalibrator``; ``launch.serve``: prefill + decode of a
         model of any family with exact int8
         calibration;
         ``launch.train``: the training loop (``launch.steps`` builds its
         step)
models   the layers, routed experts, the Mamba-2 (SSD) block and the
         assembly of every family (dense, vlm, moe, ssm, hybrid, audio), with
         their training loss; ``configs`` the registry
optim    AdamW, and exact quantiles over pytrees and channels (the
         gradient clip, int8 compression, per-channel scales)
data     the synthetic, index-addressable token pipeline
distributed  preemption, straggler and elastic-rescale logic of training
checkpoint   checkpoints of pytrees and service snapshots, in the JAX
         package's format

Entry points run where their tensor lives; those that take host data take
``device=`` (default ``"cuda"``, which raises without a card).
"""
from . import (checkpoint, configs, core, data, distributed, kernels, launch,
               models, optim, pytree)
from .core import (exact_quantile, exact_quantile_rank, gk_select,
                   gk_select_multi, gk_select_grouped, full_sort_quantile,
                   psrs_sort, afs_select, jeffers_select,
                   count_discard_rounds, approx_quantile, distributed_quantile,
                   distributed_quantile_multi, distributed_quantile_grouped)
from .launch import (IngestPool, QuantileService, StreamingCalibrator,
                     Window)
from .checkpoint import save_service_snapshot, restore_service_snapshot

__all__ = ["checkpoint", "configs", "core", "data", "distributed",
           "kernels", "launch", "models", "optim", "pytree", "exact_quantile",
           "exact_quantile_rank", "gk_select", "gk_select_multi", "gk_select_grouped",
           "full_sort_quantile", "psrs_sort", "afs_select", "jeffers_select",
           "count_discard_rounds", "approx_quantile", "distributed_quantile",
           "distributed_quantile_multi", "distributed_quantile_grouped",
           "QuantileService", "Window", "IngestPool", "StreamingCalibrator",
           "save_service_snapshot",
           "restore_service_snapshot"]
