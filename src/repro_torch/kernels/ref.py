"""Plain PyTorch versions of the port's Hopper kernels.

Each function defines the exact semantics its Hopper kernel must reproduce
(``kernels/fused_select.py``, ``partition_count.py``, ``band_count.py``,
``segmented_select.py``), and ``radix_walk_ref``/``bisect_ref`` those of the
device loops that chain them.  The CPU tests hold them against the JAX
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


def band_count_ref(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """0-d int32 count of the elements of x inside the open band (lo, hi)."""
    return ((x > lo) & (x < hi)).sum(dtype=torch.int32)


def _capped_band(x: torch.Tensor, member: torch.Tensor, cap: int,
                 largest_below: bool) -> torch.Tensor:
    """The ``cap`` largest (largest_below) or smallest members of x along the
    last axis, in that order by the total-order key, sentinel padded."""
    n = x.shape[-1]
    if not 1 <= cap <= n:
        raise ValueError(f"cap must be in [1, {n}], got {cap}")
    key = total_order_key(x)
    narrow = key.dtype
    if narrow == torch.int16:
        key = key.to(torch.int32)
    info = torch.iinfo(key.dtype)
    lo, hi = _sentinels(x.dtype, x.device)
    masked = torch.where(member, key, info.min if largest_below else info.max)
    vals = torch.topk(masked, cap, dim=-1, largest=largest_below,
                      sorted=True).values
    # values from keys, not a gather: a masked element may tie the key of a
    # real member (int min / max), and only the value matters
    out = from_total_order_key(vals.to(narrow), x.dtype)
    filled = torch.arange(cap, device=x.device) < member.sum(-1, keepdim=True)
    return torch.where(filled, out, lo if largest_below else hi)


def block_topk_ref(x: torch.Tensor, pivot, cap: int,
                   largest_below: bool) -> torch.Tensor:
    """Per-shard candidate band.

    largest_below=True : the ``cap`` largest values strictly below the pivot,
                         descending, padded with the dtype's lowest sentinel.
    largest_below=False: the ``cap`` smallest values strictly above the pivot,
                         ascending, padded with the dtype's highest sentinel.
    """
    member = x < pivot if largest_below else x > pivot
    return _capped_band(x, member, cap, largest_below)


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


def segmented_select_ref(values: torch.Tensor, keys: torch.Tensor,
                         pivots: torch.Tensor, cap: int):
    """Plain version of ``segmented_select``: for each (group g, level q) of
    the (G, Q) pivots, ``fused_select_ref`` restricted to ``keys == g`` (keys
    outside [0, G) belong to no group): ``(counts (..., G, Q, 3), below
    (..., G, Q, cap), above (..., G, Q, cap))``; 3 passes per (g, q)."""
    G, Q = pivots.shape
    counts, below, above = [], [], []
    for g in range(G):
        in_g = keys == g
        for q in range(Q):
            pivot = pivots[g, q]
            is_lt = in_g & (values < pivot)
            is_gt = in_g & (values > pivot)
            counts.append(torch.stack([
                is_lt.sum(-1, dtype=torch.int32),
                (in_g & (values == pivot)).sum(-1, dtype=torch.int32),
                is_gt.sum(-1, dtype=torch.int32)], dim=-1))
            below.append(_capped_band(values, is_lt, cap, True))
            above.append(_capped_band(values, is_gt, cap, False))
    lead = values.shape[:-1]
    return (torch.stack(counts, dim=-2).reshape(*lead, G, Q, 3),
            torch.stack(below, dim=-2).reshape(*lead, G, Q, cap),
            torch.stack(above, dim=-2).reshape(*lead, G, Q, cap))


def u32_as_int64(u: torch.Tensor) -> torch.Tensor:
    """uint32 values as int64 (torch on the CPU has no uint32 shifts or
    comparisons)."""
    return u.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def byte_histogram_ref(u: torch.Tensor, prefix: int, mask: int,
                       shift: int) -> torch.Tensor:
    """(256,) int32 histogram of byte ``(u >> shift) & 0xFF`` over the uint32
    elements of u whose masked bits equal ``prefix``."""
    w = u32_as_int64(u.reshape(-1))
    byte = (w[(w & mask) == prefix] >> shift) & 0xFF
    return torch.bincount(byte, minlength=256).to(torch.int32)


def to_sortable_u32(x: torch.Tensor) -> torch.Tensor:
    """JAX's ``ops.to_sortable_u32``: the order-preserving uint32 key of
    float32 and int32 data, bf16 and f16 through float32; float64 raises."""
    if x.dtype in (torch.bfloat16, torch.float16):
        x = x.float()
    if x.dtype not in (torch.float32, torch.int32):
        raise TypeError(f"unsupported dtype {x.dtype}")
    return (total_order_key(x) ^ -(1 << 31)).view(torch.uint32)


def from_sortable_u32(u: torch.Tensor, dtype) -> torch.Tensor:
    """JAX's ``ops.from_sortable_u32``: int32 for an int32 target, float32
    for any other."""
    k = u.view(torch.int32) ^ -(1 << 31)
    return from_total_order_key(k, torch.int32 if dtype == torch.int32
                                else torch.float32)


def _bits32(v: int, device) -> torch.Tensor:
    """A uint32 value as the int32 bits of a 0-d tensor on ``device``."""
    return torch.tensor(v, dtype=torch.int64, device=device).to(torch.int32)


def radix_walk_ref(u: torch.Tensor, k: int) -> torch.Tensor:
    """Plain version of the 4-pass radix select over sortable uint32 keys:
    each pass histograms the next byte within the prefix fixed so far and
    takes the first bin whose running count reaches k (bin 0 when none does,
    as ``argmax`` of all-False gives), lowering k by the count below it.
    Returns the key (the k-th smallest for k in [1, n]) as int32 bits."""
    prefix = mask = 0
    kk = torch.tensor(k, dtype=torch.int32)
    for shift in (24, 16, 8, 0):
        hist = byte_histogram_ref(u, prefix, mask, shift)
        csum = torch.cumsum(hist, 0, dtype=torch.int32)
        byte = int(torch.argmax((csum >= kk).to(torch.uint8)))
        kk = kk - (csum[byte] - hist[byte])
        prefix |= byte << shift
        mask |= 0xFF << shift
    return _bits32(prefix, u.device)


def bisect_ref(u: torch.Tensor, k: int) -> torch.Tensor:
    """Plain version of the 32-step bitwise search over sortable uint32 keys
    (uint32 arithmetic, wrap included): ``lo`` after halving [0, 2^32 - 1]
    by the count of keys <= mid 32 times, as int32 bits."""
    w = u32_as_int64(u.reshape(-1))
    lo, hi = 0, 0xFFFFFFFF
    for _ in range(32):
        mid = lo + (hi - lo) // 2
        c = partition_count_ref(w, mid)
        if int(c[0] + c[1]) >= k:
            hi = mid
        else:
            lo = (mid + 1) & 0xFFFFFFFF
    return _bits32(lo, u.device)
