"""Kernel-layer operations: device-dispatched wrappers and pass accounting.

``count3`` / ``band_count``    (lt, eq, gt) counts and the open-band count of
                               a flat array, one read each.
``fused_count_extract``        the speculative GK Select round over a batch
                               of shards: (lt, eq, gt) counts and both capped
                               candidate bands.
``fused_count_extract_multi``  the same against Q pivots.
``segmented_count_extract``    the grouped engine's round: counts and both
                               bands for every (group, level) of a (G, Q)
                               pivot grid, restricted to each group's keys
                               (one launch per ``MAX_PIVOTS`` pivots).
``byte_histogram``             256-bin histogram of one byte of the
                               sortable-u32 key within a prefix group.
``radix_select_kth``           exact k-th smallest in 4 byte-histogram passes,
                               no sort; ``radix_select_kth_bitwise`` the
                               32-pass bit-at-a-time search it replaces.
``to_sortable``/``from_sortable``  the order-preserving unsigned key
                               transform of the port's kernels (16-bit for
                               bf16, 32-bit for f32 and int32, 64-bit for f64).
``to_sortable_u32``/``from_sortable_u32``  JAX's 32-bit transform (bf16 and
                               f16 through f32, f64 refused), the radix
                               selects' domain.

Unlike the JAX package, which vmaps a per-shard call, the band wrappers take
the whole (P, n_i) batch and launch once for all P shards.  Each wrapper
ticks the pass counter by the full reads of the data that the chosen
implementation really makes:
  count3, band_count, byte_histogram   1 (kernel and plain alike);
  fused_count_extract(_multi)          2 per Hopper launch (histogram pass +
                                       compaction pass), 3 per pivot plain;
  segmented_count_extract              per Hopper launch, one histogram pass
                                       per slice of groups that fits in
                                       shared memory (1 at G*Q = 32*2) plus
                                       the compaction pass; 3*G*Q plain;
                                       plus 1 for each launch's key shift
                                       past the first 4096 pivots;
  radix_select_kth                     4 (the kernel forms the keys from x),
                                       5 plain (the key transform is a pass);
  radix_select_kth_bitwise             32 kernel, 33 plain.
"""
from __future__ import annotations

import threading

import torch

from . import dispatch
from .fused_select import PASSES_PER_LAUNCH, RADIX_SHIFTS, launches_for
from .partition_count import BISECT_STEPS
from .ref import (total_order_key, from_total_order_key, to_sortable_u32,
                  from_sortable_u32)
from . import segmented_select as _ss
from .segmented_select import reads_per_launch

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


def count3(x: torch.Tensor, pivot) -> torch.Tensor:
    """(lt, eq, gt) int32 counts of the flat x against the pivot
    (kernel-backed ``local_ops.count3``); uint32 x compares unsigned."""
    out, _ = dispatch.run_partition_count(x.reshape(-1), pivot)
    _tick(1)
    return out


def band_count(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """0-d int32 count of the flat x inside the open band (lo, hi)."""
    out, _ = dispatch.run_band_count(x.reshape(-1), lo, hi)
    _tick(1)
    return out


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


def segmented_count_extract(values: torch.Tensor, keys: torch.Tensor,
                            pivots, cap: int):
    """The grouped engine's round: ``(counts (P, G, Q, 3), below (P, G, Q,
    cap), above (P, G, Q, cap))`` of each shard of values (P, n_i) with int32
    keys, per (group, level) of the (G, Q) pivots, with the semantics of
    ``local_ops.grouped_count_extract``.  Flat values (n,) are one shard and
    drop the P axis."""
    vb, flat = _batched(values)
    kb, _ = _batched(keys)
    pivots = torch.as_tensor(pivots, dtype=vb.dtype, device=vb.device)
    G, Q = pivots.shape
    per = max(1, _ss.MAX_PIVOTS // Q)
    parts = []
    for g0 in range(0, G, per):
        # a grid wider than one launch takes goes in slices of groups; a
        # slice's keys are shifted by its first group (one more pass over
        # the keys), so that the other groups' keys fall outside [0, G_s)
        out, route = dispatch.run_segmented_select(
            vb, kb - g0 if g0 else kb, pivots[g0:g0 + per], cap)
        G_s = out[0].shape[1]
        _tick((reads_per_launch(vb.dtype, G_s, Q) if route == dispatch.KERNEL
               else 3 * G_s * Q) + (g0 > 0))
        parts.append(out)
    out = parts[0] if len(parts) == 1 else tuple(
        torch.cat(t, dim=1) for t in zip(*parts))
    return tuple(t[0] for t in out) if flat else out


def byte_histogram(u: torch.Tensor, prefix, mask, *, shift: int) -> torch.Tensor:
    """(256,) int32 histogram of byte ``(u >> shift) & 0xFF`` among the
    uint32 elements matching ``(u & mask) == prefix``.  The input must
    already be in the sortable-u32 domain."""
    if u.dtype != torch.uint32:
        raise TypeError(f"byte_histogram wants sortable uint32, got {u.dtype}")
    out, _ = dispatch.run_byte_histogram(u.reshape(-1), int(prefix),
                                         int(mask), shift)
    _tick(1)
    return out


RADIX_PASSES = len(RADIX_SHIFTS)   # 32 bits / 8 bits per histogram pass


def _to_dtype_like_jax(v: torch.Tensor, dtype) -> torch.Tensor:
    """``v.astype(dtype)`` as JAX casts float32: a NaN keeps its sign in
    bf16 (torch keeps the payload's top bits instead).  No host sync."""
    out = v.to(dtype)
    if dtype != torch.bfloat16:
        return out
    nan_bits = torch.where(torch.signbit(v), -0x40, 0x7FC0).to(torch.int16)
    return torch.where(torch.isnan(v), nan_bits,
                       out.view(torch.int16)).view(dtype)


def _selected(bits: torch.Tensor, dtype) -> torch.Tensor:
    out = from_sortable_u32(bits.view(torch.uint32), dtype)
    return _to_dtype_like_jax(out, dtype)


def radix_select_kth(x: torch.Tensor, k) -> torch.Tensor:
    """Exact k-th smallest (1-based) of the flat x (float32, bfloat16 or
    int32) in 4 byte-histogram passes: no sort, no data movement.  Each pass
    pins one byte of the answer's sortable-u32 key.  Bit-identical to JAX's
    ``ops.radix_select_kth``, a k outside [1, n] included."""
    bits, route = dispatch.run_radix_walk(x.reshape(-1), k)
    _tick(RADIX_PASSES + (route == dispatch.PLAIN))
    return _selected(bits, x.dtype)


def radix_select_kth_bitwise(x: torch.Tensor, k) -> torch.Tensor:
    """The 32-pass bit-at-a-time search over the sortable-u32 domain that
    ``radix_select_kth`` replaces, kept as its baseline; bit-identical to
    JAX's ``ops.radix_select_kth_bitwise``."""
    bits, route = dispatch.run_bisect(x.reshape(-1), k)
    _tick(BISECT_STEPS + (route == dispatch.PLAIN))
    return _selected(bits, x.dtype)


def make_count3_fn():
    """The count seam with ``local_ops.count3``'s signature
    ``(x, pivot) -> (lt, eq, gt)``, one read per call."""
    return count3


def make_segmented_fn():
    """The grouped count+extract seam ``(values, keys, pivots, cap) ->
    (counts (.., G, Q, 3), below (.., G, Q, cap), above (.., G, Q, cap))``."""
    return segmented_count_extract


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
