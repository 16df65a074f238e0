"""Kernel-layer operations: device-dispatched wrappers and pass accounting.

``fused_count_extract``        the speculative GK Select round over a batch
                               of shards: (lt, eq, gt) counts and both capped
                               candidate bands.
``fused_count_extract_multi``  the same against Q pivots.
``to_sortable``/``from_sortable``  the order-preserving unsigned key
                               transform (16-bit for bf16, 32-bit for f32 and
                               int32, 64-bit for f64).

Unlike the JAX package, which vmaps a per-shard call, every wrapper takes
the whole (P, n_i) batch and launches once for all P shards.  Each wrapper
ticks the pass counter by the full reads of the data that the chosen
implementation really makes: 2 per Hopper launch (histogram pass +
compaction pass), 3 per pivot for the plain version (count + two top-k).
"""
from __future__ import annotations

import threading

import torch

from . import dispatch
from .fused_select import PASSES_PER_LAUNCH, launches_for
from .ref import total_order_key, from_total_order_key

# Lock-guarded so that callers on several threads never drop a tick.
_HBM_PASSES = {"total": 0}
_HBM_LOCK = threading.Lock()


def reset_hbm_passes() -> None:
    """Zero the full-read counter."""
    with _HBM_LOCK:
        _HBM_PASSES["total"] = 0


def hbm_passes() -> int:
    """Full reads of the data dispatched since the last reset."""
    with _HBM_LOCK:
        return _HBM_PASSES["total"]


def _tick(n: int) -> None:
    with _HBM_LOCK:
        _HBM_PASSES["total"] += n


def _batched(x: torch.Tensor):
    """(n,) -> (1, n) so that a flat shard takes the batch path."""
    return (x.unsqueeze(0), True) if x.dim() == 1 else (x, False)


def fused_count_extract(x: torch.Tensor, pivot, cap: int):
    """``(counts, below, above)`` of each shard of x (P, n_i) against one
    pivot, with the semantics of ``(local_ops.count3, local_ops.extract_below,
    local_ops.extract_above)``: counts (P, 3) int32, bands (P, cap).  A flat
    x (n,) is one shard and drops the P axis."""
    xb, flat = _batched(x)
    out, route = dispatch.run_fused_select(xb, pivot, cap)
    _tick(PASSES_PER_LAUNCH if route == dispatch.KERNEL else 3)
    return tuple(t[0] for t in out) if flat else out


def fused_count_extract_multi(x: torch.Tensor, pivots, cap: int):
    """``fused_count_extract`` against Q pivots: ``(counts (P, Q, 3),
    below (P, Q, cap), above (P, Q, cap))``."""
    xb, flat = _batched(x)
    out, route = dispatch.run_fused_select_multi(xb, pivots, cap)
    q = len(pivots)
    _tick(PASSES_PER_LAUNCH * launches_for(q) if route == dispatch.KERNEL
          else 3 * q)
    return tuple(t[0] for t in out) if flat else out


def make_fused_fn():
    """The count+extract seam with ``local_ops.fused_count_extract``'s
    signature ``(x, pivot, cap) -> (counts, below, above)``."""
    return fused_count_extract


def make_fused_multi_fn():
    """The Q-pivot seam ``(x, pivots, cap) -> (counts (.., Q, 3),
    below (.., Q, cap), above (.., Q, cap))``."""
    return fused_count_extract_multi


_SIGN_BIT = {torch.int16: -(1 << 15), torch.int32: -(1 << 31),
             torch.int64: -(1 << 63)}
_UNSIGNED = {torch.int16: torch.uint16, torch.int32: torch.uint32,
             torch.int64: torch.uint64}


def to_sortable(x: torch.Tensor) -> torch.Tensor:
    """Order-preserving map into unsigned keys of x's width: uint16 for bf16,
    uint32 for f32 and int32 (the bits of JAX's ``to_sortable_u32``), uint64
    for f64."""
    k = total_order_key(x)
    return (k ^ _SIGN_BIT[k.dtype]).view(_UNSIGNED[k.dtype])


def from_sortable(u: torch.Tensor, dtype) -> torch.Tensor:
    """Inverse of ``to_sortable``."""
    signed = {v: s for s, v in _UNSIGNED.items()}[u.dtype]
    return from_total_order_key(u.view(signed) ^ _SIGN_BIT[signed], dtype)
