"""The paper's comparison suite (§IV), in PyTorch: Full Sort, PSRS (the
structure of Spark's range-partitioning sort), Al-Furaih Select (AFS),
Jeffers Select, and the sketch-only approximate quantile.

Counterpart of ``repro/core/baselines.py``: single-process versions over
(P, n_i) partitioned arrays, as ``core.select``.  The sharded plans live in
``core.engine`` (``count_discard_sharded``, ``full_sort_sharded``).

``psrs_sort`` is deterministic and gives the reference's bits.  The
count-and-discard selects draw their pivots from a ``torch.Generator``
where the reference draws threefry, so their round counts differ from
JAX's; their answers are the sort's.  Where the target rank sits on a
dtype extreme (+-inf, the int extremes) they end on the boundary that
holds it, as the sharded plans do, where the reference's single-process
loop runs out its rounds on a wrong element.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import local_ops
from ..kernels.ref import _sentinels
from .sketch import local_sample_sketch, query_merged_sketch, sample_sketch_params


# ---------------------------------------------------------------------------
# Full sort (Spark orderBy / PSRS)
# ---------------------------------------------------------------------------


def full_sort_quantile(parts: torch.Tensor, q: float) -> torch.Tensor:
    """Exact quantile by a global sort: the O(n log n) baseline."""
    k = local_ops.target_rank(parts.numel(), q)
    return local_ops.stable_sort(parts.reshape(-1))[k - 1]


def psrs_sort(parts: torch.Tensor, num_splitter_samples: int = 32
              ) -> torch.Tensor:
    """Parallel Sort by Regular Sampling (§IV-A): per-shard regular samples
    -> splitters -> a bucket for every record -> (simulated) shuffle -> a
    sort within each bucket.  Returns the globally sorted flat array.

    The reference's ``jnp.lexsort((values, bucket))`` is two stable sorts
    here, by value (``jnp.sort``'s order: -0.0 and +0.0 tie) and then by
    bucket; each intermediate is dropped once used, so that 10^9 values
    fit one card."""
    P, n_i = parts.shape
    flat = parts.reshape(-1)
    # 1) regular sampling per shard
    local_sorted = local_ops.stable_sort(parts, dim=1)
    stride = max(1, n_i // num_splitter_samples)
    samples = local_sorted[:, ::stride][:, :num_splitter_samples]
    del local_sorted
    # 2-3) collect + splitter selection
    ssorted = local_ops.stable_sort(samples.reshape(-1))
    step = ssorted.numel() // P
    splitters = ssorted[step::step][: P - 1].contiguous()
    # 4) range partitioning: the bucket of every record (the shuffle key)
    bucket = torch.searchsorted(splitters, flat, right=True, out_int32=True)
    # 5) the simulated shuffle: a stable sort by (bucket, value)
    order = local_ops.stable_argsort(flat)
    by_bucket = torch.sort(bucket[order], stable=True).indices
    del bucket
    order = order[by_bucket]
    del by_bucket
    return flat[order]


# ---------------------------------------------------------------------------
# Count-and-discard selection (AFS / Jeffers)
# ---------------------------------------------------------------------------


def _count_discard(parts: torch.Tensor, q: float, *, max_rounds: int,
                   seed: int) -> Tuple[torch.Tensor, int]:
    """Shared body of AFS and Jeffers: O(log n) expected rounds, each one
    count of every shard (``local_ops.count3``) and a pivot drawn uniformly
    from the open band (lo, hi) that still holds rank k (the argmax of
    uniform priorities over the band's mask).  Returns (answer, rounds:
    the counts made).

    The band's population comes from carried rank masses #{x <= lo} and
    #{x < hi}; when it empties, rank k sits on a boundary (a value equal to
    a dtype extreme is never a pivot), and the loop ends on the boundary
    whose side holds it."""
    n = parts.numel()
    k = local_ops.target_rank(n, q)
    lo, hi = _sentinels(parts.dtype, parts.device)
    gen = torch.Generator(device=parts.device).manual_seed(int(seed))
    flat = parts.reshape(-1)

    def candidate(lo_, hi_) -> torch.Tensor:
        pri = torch.rand(flat.shape, generator=gen, device=flat.device)
        pri = torch.where((flat > lo_) & (flat < hi_), pri, -1.0)
        return flat[torch.argmax(pri)]

    def counts(pivot) -> list:
        return local_ops.count3(parts, pivot).sum(0).tolist()

    c_lo, c_hi = counts(lo), counts(hi)
    n_le_lo, n_lt_hi = c_lo[0] + c_lo[1], c_hi[0]
    lo_, hi_ = lo, hi
    ans = pivot = candidate(lo_, hi_)
    rounds = 0
    while rounds < max_rounds:
        if n_lt_hi == n_le_lo:                        # the band is empty
            ans = lo_ if k <= n_le_lo else hi_
            break
        lt, eq, _ = counts(pivot)
        rounds += 1
        if lt < k <= lt + eq:
            ans = pivot
            break
        if k <= lt:
            hi_, n_lt_hi = pivot, lt
        else:
            lo_, n_le_lo = pivot, lt + eq
        pivot = candidate(lo_, hi_)
    return ans, rounds


def afs_select(parts: torch.Tensor, q: float, *, max_rounds: int = 128,
               seed: int = 0) -> torch.Tensor:
    """Al-Furaih Select (serial pivot, parallel count)."""
    return _count_discard(parts, q, max_rounds=max_rounds, seed=seed)[0]


def jeffers_select(parts: torch.Tensor, q: float, *, max_rounds: int = 128,
                   seed: int = 1) -> torch.Tensor:
    """Jeffers Select: the same recurrence as AFS (the distributed plan
    differs only in how it collects the counts), another seed."""
    return _count_discard(parts, q, max_rounds=max_rounds, seed=seed)[0]


def count_discard_rounds(parts: torch.Tensor, q: float, *,
                         max_rounds: int = 128, seed: int = 0) -> int:
    """The rounds (counts) that ``afs_select`` makes, for Table V."""
    return _count_discard(parts, q, max_rounds=max_rounds, seed=seed)[1]


# ---------------------------------------------------------------------------
# Approximate-only baseline (Spark approxQuantile)
# ---------------------------------------------------------------------------


def approx_quantile(parts: torch.Tensor, q: float, *,
                    eps: float = 0.01) -> torch.Tensor:
    """Sketch-only path: rank error <= eps*n, one round, no exactness."""
    P, n_i = parts.shape
    n = P * n_i
    k = local_ops.target_rank(n, q)
    m, s = sample_sketch_params(n, n_i, eps, P)
    vals, weights = local_sample_sketch(parts, m, s)
    return query_merged_sketch(vals.reshape(-1), weights.reshape(-1), k, P, m)
