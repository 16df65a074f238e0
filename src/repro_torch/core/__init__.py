"""GK Select on one device in PyTorch.

  exact_quantile / exact_quantile_rank / gk_select / gk_select_multi
  gk_select_grouped                           every group x level in one job
  full_sort_quantile / approx_quantile        the quickstart's baselines
  local_sample_sketch / query_merged_sketch / sample_sketch_params
  reset_sketch_sorts / sketch_sorts / record_sketch_sort
  local_ops / engine / grouped                the modules behind them
"""
from .sketch import (local_sample_sketch, query_merged_sketch,
                     sample_sketch_params, reset_sketch_sorts, sketch_sorts,
                     record_sketch_sort)
from .select import (exact_quantile, exact_quantile_rank, gk_select,
                     gk_select_multi, as_device_tensor)
from .baselines import full_sort_quantile, approx_quantile
from .grouped import gk_select_grouped
from . import engine, grouped, local_ops

__all__ = [
    "local_sample_sketch", "query_merged_sketch", "sample_sketch_params",
    "reset_sketch_sorts", "sketch_sorts", "record_sketch_sort",
    "exact_quantile", "exact_quantile_rank", "gk_select", "gk_select_multi",
    "as_device_tensor", "full_sort_quantile", "approx_quantile",
    "gk_select_grouped", "engine", "grouped", "local_ops",
]
