"""GK Select, the paper's exact quantile, on one device in PyTorch.

Counterpart of ``repro/core/select.py``.  Data is a (P, n_i) tensor whose
leading axis plays the partitions; every function runs where that tensor
lives.  Rounds (paper section V):
  1: per-shard sample sketch -> merged pivot
  2: per-shard 3-way counts -> global rank gap
  3: per-shard candidate extraction -> exact value
``speculative=True`` extracts both sides in the counting round;
``block_select=True`` runs that round through the Hopper kernels
(``kernels.ops.fused_count_extract``) on a CUDA tensor, in two passes over
the data for all P shards.
"""
from __future__ import annotations

import numpy as np
import torch

from . import local_ops
from .sketch import local_sample_sketch, query_merged_sketch, sample_sketch_params
from ..kernels import ops as kernel_ops


def _pivots_from_sample_sketch(parts: torch.Tensor, k: torch.Tensor,
                               eps: float) -> torch.Tensor:
    P, n_i = parts.shape
    m, s = sample_sketch_params(P * n_i, n_i, eps, P)
    vals, weights = local_sample_sketch(parts, m, s)
    return query_merged_sketch(vals.reshape(-1), weights.reshape(-1), k, P, m)


def gk_select(parts: torch.Tensor, q: float, *, eps: float = 0.01,
              speculative: bool = False, block_select: bool = False,
              k: int = None, check_nans: bool = True) -> torch.Tensor:
    """Exact q-quantile (k = ceil(q*n), 1-based) of a (P, n_i) tensor, as a
    0-d tensor on its device.

    The result is bit-identical to ``sorted(parts.ravel())[k - 1]`` whatever
    ``eps``, ``speculative`` or ``block_select``: those change the data
    movement, never the answer.  ``k`` addresses the target by rank and
    overrides ``q`` (pass q=None).  NaN policy: reject (``ValueError``);
    ``check_nans=False`` skips that extra pass.  The faithful 3-round mode
    reads the rank gap's sign on the host to scan only the deficient side.
    """
    if check_nans:
        local_ops.reject_nans(parts, "gk_select")
    P, n_i = parts.shape
    n = P * n_i
    rank = local_ops.target_rank(n, q) if k is None else int(min(n, max(1, k)))
    kt = torch.tensor(rank, device=parts.device)

    pivot = _pivots_from_sample_sketch(parts, kt, eps)
    cap = local_ops.candidate_cap(n, eps, n_i)

    if block_select or speculative:
        extract = (kernel_ops.fused_count_extract if block_select
                   else local_ops.fused_count_extract)
        counts, below, above = extract(parts, pivot, cap)
        counts = counts.sum(0)
        return local_ops.resolve(pivot, kt, counts[0], counts[1], below, above,
                                 cap)

    counts = local_ops.count3(parts, pivot).sum(0)
    lt, eq = counts[0], counts[1]
    need_left = lt - kt + 1
    need_right = kt - (lt + eq)
    if bool(need_left > 0):
        below = local_ops.extract_below(parts, pivot, cap)
        side_val = local_ops.kth_largest(below, need_left.clamp(min=1), cap)
    else:
        above = local_ops.extract_above(parts, pivot, cap)
        side_val = local_ops.kth_smallest(above, need_right.clamp(min=1), cap)
    return torch.where((need_left <= 0) & (need_right <= 0), pivot, side_val)


def gk_select_multi(parts: torch.Tensor, qs: tuple, *, eps: float = 0.01,
                    speculative: bool = True, block_select: bool = False,
                    check_nans: bool = True) -> torch.Tensor:
    """Q quantiles in one job, as a (Q,) tensor: the sketch is shared, and
    with ``block_select=True`` the kernel answers all Q pivots from the same
    two passes over the data.  Every level is bit-identical to the sort
    oracle.  NaN policy as ``gk_select``."""
    if check_nans:
        local_ops.reject_nans(parts, "gk_select_multi")
    P, n_i = parts.shape
    n = P * n_i
    ks = torch.tensor([local_ops.target_rank(n, q) for q in qs],
                      device=parts.device)
    pivots = _pivots_from_sample_sketch(parts, ks, eps)
    cap = local_ops.candidate_cap(n, eps, n_i)

    if block_select:
        counts, below, above = kernel_ops.fused_count_extract_multi(
            parts, pivots, cap)
        counts = counts.sum(0)                       # (Q, 3)
        return torch.stack([
            local_ops.resolve(pivots[i], ks[i], counts[i, 0], counts[i, 1],
                              below[:, i], above[:, i], cap)
            for i in range(len(qs))])

    out = []
    for i in range(len(qs)):
        counts, below, above = local_ops.fused_count_extract(parts, pivots[i], cap)
        counts = counts.sum(0)
        out.append(local_ops.resolve(pivots[i], ks[i], counts[0], counts[1],
                                     below, above, cap))
    return torch.stack(out)


def as_device_tensor(x, device="cuda") -> torch.Tensor:
    """A tensor as it is, or host data (numpy, incl. ml_dtypes bfloat16, or
    a sequence) moved to ``device``.  ``device="cuda"`` without a card
    raises: pass ``device="cpu"`` to run on the CPU."""
    if isinstance(x, torch.Tensor):
        return x
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.as_tensor(a, device=device)


def exact_quantile(x, q: float, *, eps: float = 0.01,
                   num_partitions: int = 8, device="cuda") -> torch.Tensor:
    """Flat-array wrapper: reshape into P pseudo-partitions and run GK
    Select.  x.size must be divisible by num_partitions.  Host data goes to
    ``device``; a tensor stays where it is.  NaN policy: reject."""
    x = as_device_tensor(x, device)
    n = x.numel()
    if n % num_partitions:
        raise ValueError(f"size {n} not divisible by P={num_partitions}")
    return gk_select(x.reshape(num_partitions, n // num_partitions), q, eps=eps)


def exact_quantile_rank(x, k: int, *, eps: float = 0.01,
                        num_partitions: int = 8, device="cuda") -> torch.Tensor:
    """Rank-addressed ``exact_quantile``: the k-th smallest (1-based) element
    of the flat array.  NaN policy: reject."""
    x = as_device_tensor(x, device)
    n = x.numel()
    if n % num_partitions:
        raise ValueError(f"size {n} not divisible by P={num_partitions}")
    if not 1 <= k <= n:
        raise ValueError(f"rank k={k} outside [1, {n}]")
    return gk_select(x.reshape(num_partitions, n // num_partitions), None,
                     k=int(k), eps=eps)
