"""GK Select on one device in PyTorch.

  exact_quantile / exact_quantile_rank / gk_select / gk_select_multi
  gk_select_grouped                           every group x level in one job
  distributed_quantile(_multi) / distributed_quantile_grouped
                                              the same over torch.distributed:
                                              each rank holds one shard
  Collectives / reset_collectives / collectives
                                              the collective layer and its
                                              counters
  full_sort_quantile / psrs_sort / afs_select / jeffers_select /
  count_discard_rounds / approx_quantile      the paper's baselines (§IV)
  local_sample_sketch / query_merged_sketch / sample_sketch_params
  reset_sketch_sorts / sketch_sorts / record_sketch_sort
  local_ops / engine / grouped / distributed  the modules behind them
"""
from .sketch import (local_sample_sketch, query_merged_sketch,
                     sample_sketch_params, reset_sketch_sorts, sketch_sorts,
                     record_sketch_sort)
from .select import (exact_quantile, exact_quantile_rank, gk_select,
                     gk_select_multi, as_device_tensor)
from .baselines import (full_sort_quantile, psrs_sort, afs_select,
                        jeffers_select, approx_quantile, count_discard_rounds)
from .grouped import gk_select_grouped, distributed_quantile_grouped
from .engine import Collectives, reset_collectives, collectives
from .distributed import distributed_quantile, distributed_quantile_multi
from . import distributed, engine, grouped, local_ops

__all__ = [
    "local_sample_sketch", "query_merged_sketch", "sample_sketch_params",
    "reset_sketch_sorts", "sketch_sorts", "record_sketch_sort",
    "exact_quantile", "exact_quantile_rank", "gk_select", "gk_select_multi",
    "as_device_tensor", "full_sort_quantile", "psrs_sort", "afs_select",
    "jeffers_select", "approx_quantile", "count_discard_rounds",
    "gk_select_grouped", "distributed_quantile", "distributed_quantile_multi",
    "distributed_quantile_grouped", "Collectives", "reset_collectives",
    "collectives", "distributed", "engine", "grouped", "local_ops",
]
