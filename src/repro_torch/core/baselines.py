"""The quickstart's comparison paths, in PyTorch: the exact global sort and
the sketch-only approximate quantile (counterparts of
``repro/core/baselines.py::full_sort_quantile`` and ``::approx_quantile``).
The count-and-discard selects and PSRS are not ported yet."""
from __future__ import annotations

import torch

from . import local_ops
from .sketch import local_sample_sketch, query_merged_sketch, sample_sketch_params


def full_sort_quantile(parts: torch.Tensor, q: float) -> torch.Tensor:
    """Exact quantile by a global sort: the O(n log n) baseline."""
    k = local_ops.target_rank(parts.numel(), q)
    return local_ops.stable_sort(parts.reshape(-1))[k - 1]


def approx_quantile(parts: torch.Tensor, q: float, *,
                    eps: float = 0.01) -> torch.Tensor:
    """Sketch-only path: rank error <= eps*n, one round, no exactness."""
    P, n_i = parts.shape
    n = P * n_i
    k = local_ops.target_rank(n, q)
    m, s = sample_sketch_params(n, n_i, eps, P)
    vals, weights = local_sample_sketch(parts, m, s)
    return query_merged_sketch(vals.reshape(-1), weights.reshape(-1), k, P, m)
