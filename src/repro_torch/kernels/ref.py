"""Plain PyTorch versions of the fused count+extract kernels.

Each function defines the exact semantics its Hopper kernel must reproduce
(``kernels/fused_select.py``).  The CPU tests hold them against the JAX
package's oracles bit for bit, and ``chip_smoke.py`` holds the kernels
against them on the card.  The main path never calls them on a CUDA tensor.

Bands are selected and ordered in the total order that ``lax.top_k`` uses:
+0.0 ranks above -0.0, so the selection runs on the integer key of
``total_order_key`` and never on the float values.  All functions work on
the last axis of ``x`` and broadcast over the leading ones (a batch of
shards).
"""
from __future__ import annotations

import torch

_INT_VIEW = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
             torch.float64: torch.int64}


def _sentinels(dtype, device=None):
    """(lowest, highest) padding sentinels: +-inf for floats, int min/max."""
    if dtype.is_floating_point:
        lo, hi = float("-inf"), float("inf")
    else:
        info = torch.iinfo(dtype)
        lo, hi = info.min, info.max
    return (torch.tensor(lo, dtype=dtype, device=device),
            torch.tensor(hi, dtype=dtype, device=device))


def total_order_key(x: torch.Tensor) -> torch.Tensor:
    """Signed integer key of x's width whose order is the total order of
    the values: -inf < ... < -0.0 < +0.0 < ... < +inf.  int32 is its own
    key; a negative float flips its 31 (15, 63) magnitude bits."""
    if x.dtype == torch.int32:
        return x
    if x.dtype not in _INT_VIEW:
        raise TypeError(f"unsupported dtype {x.dtype}")
    b = x.view(_INT_VIEW[x.dtype])
    return b ^ ((b >> (torch.iinfo(b.dtype).bits - 1)) & torch.iinfo(b.dtype).max)


def from_total_order_key(k: torch.Tensor, dtype) -> torch.Tensor:
    """Inverse of ``total_order_key`` (the map is its own inverse on bits)."""
    if dtype == torch.int32:
        return k
    b = k ^ ((k >> (torch.iinfo(k.dtype).bits - 1)) & torch.iinfo(k.dtype).max)
    return b.view(dtype)


def partition_count_ref(x: torch.Tensor, pivot) -> torch.Tensor:
    """(lt, eq, gt) int32 counts along the last axis vs pivot."""
    lt = (x < pivot).sum(-1, dtype=torch.int32)
    eq = (x == pivot).sum(-1, dtype=torch.int32)
    gt = x.shape[-1] - lt - eq
    return torch.stack([lt, eq, gt], dim=-1)


def block_topk_ref(x: torch.Tensor, pivot, cap: int,
                   largest_below: bool) -> torch.Tensor:
    """Per-shard candidate band.

    largest_below=True : the ``cap`` largest values strictly below the pivot,
                         descending, padded with the dtype's lowest sentinel.
    largest_below=False: the ``cap`` smallest values strictly above the pivot,
                         ascending, padded with the dtype's highest sentinel.
    """
    n = x.shape[-1]
    if not 1 <= cap <= n:
        raise ValueError(f"cap must be in [1, {n}], got {cap}")
    key = total_order_key(x)
    narrow = key.dtype
    if narrow == torch.int16:
        key = key.to(torch.int32)
    info = torch.iinfo(key.dtype)
    lo, hi = _sentinels(x.dtype, x.device)
    if largest_below:
        member = x < pivot
        masked = torch.where(member, key, info.min)
        sentinel = lo
    else:
        member = x > pivot
        masked = torch.where(member, key, info.max)
        sentinel = hi
    vals = torch.topk(masked, cap, dim=-1, largest=largest_below,
                      sorted=True).values
    # values from keys, not a gather: a masked element may tie the key of a
    # real member (int min / max), and only the value matters
    out = from_total_order_key(vals.to(narrow), x.dtype)
    filled = torch.arange(cap, device=x.device) < member.sum(-1, keepdim=True)
    return torch.where(filled, out, sentinel)


def fused_select_ref(x: torch.Tensor, pivot, cap: int):
    """Plain version of ``fused_select``: ``(counts (..., 3), below (..., cap),
    above (..., cap))`` as three whole-array passes."""
    return (partition_count_ref(x, pivot),
            block_topk_ref(x, pivot, cap, largest_below=True),
            block_topk_ref(x, pivot, cap, largest_below=False))


def fused_select_multi_ref(x: torch.Tensor, pivots: torch.Tensor, cap: int):
    """Plain version of ``fused_select_multi``: ``fused_select_ref`` for each
    of the Q pivots, stacked as ``(counts (..., Q, 3), below (..., Q, cap),
    above (..., Q, cap))``; 3 passes per pivot."""
    outs = [fused_select_ref(x, pivots[i], cap) for i in range(pivots.shape[0])]
    return tuple(torch.stack(parts, dim=-2) for parts in zip(*outs))
