"""Public entry points for distributed quantiles over ``torch.distributed``.

Counterpart of ``repro/core/distributed.py``.  Every rank of the process
group ``group`` (default: the world) calls the entry point with its own
shard, a flat tensor, and gets the replicated answer.  Spark's roles map to
the collectives of ``engine.Collectives``:

  collect sketches       -> all_gather   (replicated merge, no driver)
  TorrentBroadcast pivot -> free (pivot computed replicated post-gather)
  collect counts         -> all_reduce (int32 sum)
  treeReduce candidates  -> <= log2(P)+2 ppermute steps, a butterfly
                            generalized to any rank count, or one capped
                            all_gather (reduce_strategy="all_gather")

The JAX entry points check the global array before they enter the shard
map.  Here each rank sees only its shard, so the checks are agreed in one
all_reduce (``engine.check_shards``): all ranks raise together when the
shard lengths differ, when a shard is malformed, or (``check_nans``) when
any shard holds a NaN.  The kernels run where the shards live: the Hopper
kernels on CUDA shards, their plain versions on CPU shards.
"""
from __future__ import annotations

from typing import Sequence

import torch

from .engine import (Collectives, check_shards, gk_select_sharded,
                     gk_select_multi_sharded, approx_quantile_sharded,
                     count_discard_sharded, full_sort_sharded)
from .select import as_device_tensor
from ..kernels import ops as kernel_ops

METHODS = ("gk_select", "approx", "afs", "jeffers", "full_sort")


def distributed_quantile(x, q: float, *, group=None, eps: float = 0.01,
                         method: str = "gk_select", speculative: bool = False,
                         reduce_strategy: str = "tree", fused: bool = False,
                         check_nans: bool = True,
                         device="cuda") -> torch.Tensor:
    """Exact (or approximate, method='approx') quantile of the 1-D array
    whose shards the ranks of ``group`` hold, as a 0-d tensor on every rank.

    For every exact method ('gk_select', 'afs', 'jeffers', 'full_sort') the
    answer is bit-identical to the global sort oracle; eps and the flags
    only steer data movement.  'gk_select' runs the faithful one-sided plan
    (counts by ``kernels.ops.count3``: ``partition_count`` on a CUDA
    shard), or with ``speculative=True`` both sides at once, or with
    ``fused=True`` the ``fused_select`` kernel's one launch.  NaN policy:
    reject; ``check_nans=False`` skips that read and hands the NaN-free
    contract to the caller.  Host data goes to ``device``; a tensor stays
    where it is."""
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; one of {METHODS}")
    if fused and method != "gk_select":
        raise ValueError(f"fused=True only applies to method='gk_select', "
                         f"got method={method!r}")
    x = as_device_tensor(x, device)
    coll = Collectives(group)
    check_shards(coll, x, "distributed_quantile",
                 problem=None if x.dim() == 1 else "expects a flat shard",
                 check_nans=check_nans)
    if method == "gk_select":
        return gk_select_sharded(
            x, q=q, eps=eps, coll=coll, speculative=speculative,
            reduce_strategy=reduce_strategy,
            count3_fn=kernel_ops.make_count3_fn(),
            fused_fn=kernel_ops.make_fused_fn() if fused else None)
    if method == "approx":
        return approx_quantile_sharded(x, q=q, eps=eps, coll=coll)
    if method == "full_sort":
        return full_sort_sharded(x, q=q, coll=coll)
    return count_discard_sharded(x, q=q, coll=coll,
                                 collect_counts=method == "jeffers")


def distributed_quantile_multi(x, qs: Sequence[float], *, group=None,
                               eps: float = 0.01,
                               reduce_strategy: str = "tree",
                               fused: bool = False, pivots=None,
                               cap: int = None, check_nans: bool = True,
                               device="cuda") -> torch.Tensor:
    """Exact quantiles at every level of ``qs`` from one sharded job: one
    sketch phase, one count+extract pass per shard (``fused=True``: one
    ``fused_select_multi`` launch for all levels on a CUDA shard), one
    butterfly for all Q candidate buffers.  Returns the (Q,) values on
    every rank, each bit-identical to the sort oracle.

    ``pivots`` (Q values: a tensor, numpy or a sequence) runs the job warm,
    with no sketch phase; ``cap`` then sizes the candidate buffers from the
    supplier's rank bound.  NaN policy as ``distributed_quantile``."""
    qs = tuple(float(q) for q in qs)
    if not qs:
        raise ValueError("qs must name at least one quantile level")
    x = as_device_tensor(x, device)
    coll = Collectives(group)
    check_shards(coll, x, "distributed_quantile_multi",
                 problem=None if x.dim() == 1 else "expects a flat shard",
                 check_nans=check_nans)
    return gk_select_multi_sharded(
        x, qs=qs, eps=eps, coll=coll, reduce_strategy=reduce_strategy,
        fused_fn=kernel_ops.make_fused_multi_fn() if fused else None,
        pivots=pivots, cap=cap)
