"""The sample sketch that GK Select pivots on, in PyTorch.

Counterpart of the sample-sketch part of ``repro/core/sketch.py``: sort each
shard, keep every m-th element with the count it covers, and query the
merged samples for the pivot of rank k.  The streaming ``SketchState`` and
the host ``GKSketch`` are not ported yet.
"""
from __future__ import annotations

import math
import threading
from typing import Tuple

import torch

from .local_ops import stable_argsort

# Sketch-phase sort accounting, ticked by every code path that sorts raw
# data to build or rebuild a sketch.  Lock-guarded so that no tick is lost.
_SKETCH_SORTS = {"total": 0}
_SKETCH_SORTS_LOCK = threading.Lock()


def reset_sketch_sorts() -> None:
    """Zero the sketch-phase sort counter."""
    with _SKETCH_SORTS_LOCK:
        _SKETCH_SORTS["total"] = 0


def sketch_sorts() -> int:
    """Sketch-construction sorts dispatched since the last reset."""
    with _SKETCH_SORTS_LOCK:
        return _SKETCH_SORTS["total"]


def record_sketch_sort(n: int = 1) -> None:
    """Tick the sketch-phase sort counter.  Thread-safe."""
    with _SKETCH_SORTS_LOCK:
        _SKETCH_SORTS["total"] += n


def sample_sketch_params(n_total: int, n_local: int, eps: float,
                         num_shards: int) -> Tuple[int, int]:
    """(stride m, samples per shard s) for a target rank error eps*n: the
    summed per-shard uncertainty P*m stays <= eps*n, and s = ceil(n_local/m)
    samples cover the shard including a final partial group."""
    if not 0.0 < eps < 1.0:
        raise ValueError(f"eps must be in (0,1), got {eps}")
    m = max(1, int(math.floor(eps * n_total / max(1, num_shards))))
    m = min(m, n_local)
    s = int(math.ceil(n_local / m))
    return m, s


def local_sample_sketch(x: torch.Tensor, m: int, s: int):
    """Sorted stride-m summary of each shard along the last axis.

    Returns (values (..., s), weights (..., s) int32): sample t is the
    element of local rank min((t+1)*m, n_i); its weight is the number of
    elements it covers.  Clamped duplicates at the tail get weight 0.
    """
    n_i = x.shape[-1]
    order = stable_argsort(x, dim=-1)
    idx = torch.clamp(torch.arange(1, s + 1, device=x.device) * m - 1,
                      max=n_i - 1)
    vals = torch.gather(x, -1, order[..., idx])
    prev = torch.cat([idx.new_full((1,), -1), idx[:-1]])
    weights = (idx - prev).to(torch.int32).expand(vals.shape)
    return vals, weights


def query_merged_sketch(values: torch.Tensor, weights: torch.Tensor, k,
                        num_shards: int, m: int) -> torch.Tensor:
    """The pivot for rank k from the concatenated per-shard summaries
    (flat (P*s,)).  rank(v_t) lies in [cum_t, cum_t + P*m], so the midpoint
    estimate is within eps*n of the chosen sample's true rank.  ``k`` may be
    a (Q,) tensor of ranks: the result is then the Q pivots."""
    order = stable_argsort(values)
    v = values[order]
    cum = torch.cumsum(weights[order], 0)          # exact ranks
    est = cum + num_shards * m // 2
    k = torch.as_tensor(k, dtype=est.dtype, device=est.device)
    t = torch.argmin((est - k.unsqueeze(-1)).abs(), dim=-1)
    return v[t]
