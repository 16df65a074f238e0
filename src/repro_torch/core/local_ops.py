"""Per-shard primitives of GK Select, in PyTorch.

Counterpart of ``repro/core/local_ops.py``.  Every function works on the
last axis and broadcasts over leading ones, so a (P, n_i) batch of shards
goes through one call where the JAX package vmaps.  These are the plain
versions; ``kernels.ops.fused_count_extract`` is the kernel-backed seam.
"""
from __future__ import annotations

import math

import torch

from ..kernels.ref import (_sentinels, block_topk_ref, partition_count_ref,
                           segmented_select_ref)


def pad_with_high_sentinel(x: torch.Tensor, multiple: int, *,
                           axis: int = -1) -> torch.Tensor:
    """Pad ``axis`` up to a multiple of ``multiple`` with the dtype's highest
    sentinel (+inf / int max), which never moves the k-th smallest for any
    k <= the true count."""
    pad = (-x.shape[axis]) % multiple
    if pad:
        _, hi = _sentinels(x.dtype, x.device)
        shape = list(x.shape)
        shape[axis] = pad
        x = torch.cat([x, hi.expand(shape)], dim=axis)
    return x


def reject_nans(x: torch.Tensor, where: str) -> None:
    """NaN policy: reject.  A NaN compares False against every pivot, so the
    3-way counts stop summing to n; float inputs holding NaN raise
    ``ValueError``.  The check is one extra pass and a host sync."""
    if not x.is_floating_point():
        return
    if bool(torch.isnan(x).any()):
        raise ValueError(
            f"{where}: input contains NaN — quantiles are undefined over a "
            f"non-total order (NaN policy: reject)")


def stable_argsort(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Stable ascending argsort with ``jnp.sort``'s order: -0.0 and +0.0
    compare equal and keep their input order.  (Adding +0.0 turns -0.0 into
    +0.0, so a radix sort on the card cannot split them either.)"""
    keys = x + 0 if x.is_floating_point() else x
    return torch.sort(keys, dim=dim, stable=True).indices


def stable_sort(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``jnp.sort(x, axis=dim)``, bit for bit (see ``stable_argsort``)."""
    return torch.gather(x, dim, stable_argsort(x, dim))


def count3(x: torch.Tensor, pivot) -> torch.Tensor:
    """(lt, eq, gt) int32 counts of each shard vs the pivot."""
    return partition_count_ref(x, pivot)


def candidate_cap(n_total: int, eps: float, n_local: int) -> int:
    """Per-shard candidate capacity: the sketch bounds |Delta_k| by eps*n, so
    ceil(eps*n)+2 lanes hold every candidate a shard can give (clamped to
    the shard size)."""
    return int(min(n_local, math.ceil(eps * n_total) + 2))


def extract_above(x: torch.Tensor, pivot, cap: int) -> torch.Tensor:
    """The ``cap`` smallest values strictly above the pivot, ascending;
    missing lanes are +sentinel."""
    return block_topk_ref(x, pivot, cap, largest_below=False)


def extract_below(x: torch.Tensor, pivot, cap: int) -> torch.Tensor:
    """The ``cap`` largest values strictly below the pivot, descending;
    missing lanes are -sentinel."""
    return block_topk_ref(x, pivot, cap, largest_below=True)


def fused_count_extract(x: torch.Tensor, pivot, cap: int):
    """``(count3, extract_below, extract_above)`` of each shard: the plain
    speculative round (three passes)."""
    return count3(x, pivot), extract_below(x, pivot, cap), extract_above(x, pivot, cap)


def kth_smallest(cands: torch.Tensor, k, cap: int) -> torch.Tensor:
    """k-th smallest (1-based, k a tensor) among all candidate lanes; invalid
    lanes must be +sentinel so that they sort last."""
    srt = stable_sort(cands.reshape(-1))
    idx = (torch.as_tensor(k, device=srt.device) - 1).clamp(0, srt.numel() - 1)
    return srt[idx]


def kth_largest(cands: torch.Tensor, k, cap: int) -> torch.Tensor:
    """k-th largest: ``jnp.sort(...)[::-1]``, an ascending stable sort
    reversed (not a descending sort, which orders ties the other way)."""
    srt = stable_sort(cands.reshape(-1)).flip(0)
    idx = (torch.as_tensor(k, device=srt.device) - 1).clamp(0, srt.numel() - 1)
    return srt[idx]


def target_rank(n: int, q: float) -> int:
    """1-based target rank k = clamp(ceil(q*n), 1, n), on the host."""
    return int(min(n, max(1, math.ceil(q * n))))


def exact_target_rank(n: int, q: float) -> int:
    """k = ceil(q*n) over the exact dyadic rational that the float q is,
    clamped to [1, max(n, 1)]; differs from ``target_rank`` only when q*n
    lies within one double ulp of an integer."""
    a, b = float(q).as_integer_ratio()
    if not 0 < a <= b:
        raise ValueError(f"q must be in (0, 1], got {q}")
    return int(min(max(n, 1), max(1, -((-a * n) // b))))


def target_rank_traced(n: torch.Tensor, q: float) -> torch.Tensor:
    """``exact_target_rank`` for an int32 count tensor ``n`` (static q), on
    n's device: k = ceil(q * n) over the exact dyadic rational q = a / 2^t,
    clamped to [1, max(n, 1)], elementwise.

    a * n (a up to 2^53, n < 2^31) overflows int64, so the product is formed
    in base-2^10 int32 limbs, as the JAX package does: every partial product
    and carry stays far below 2^31.  Empty groups (n == 0) get k = 1, which
    resolve turns into the dtype's high sentinel."""
    a, b = float(q).as_integer_ratio()
    if not 0 < a <= b:
        raise ValueError(f"q must be in (0, 1], got {q}")
    t = b.bit_length() - 1                       # b == 2**t (q is a float)
    n = torch.as_tensor(n).to(torch.int32)
    n_limbs = [(n >> (10 * j)) & 1023 for j in range(4)]         # n < 2^31
    a_limbs = [(a >> (10 * i)) & 1023
               for i in range(max(1, -(-a.bit_length() // 10)))]
    L = len(a_limbs) + 4
    r = [torch.zeros_like(n) for _ in range(L + 1)]
    for i, ai in enumerate(a_limbs):             # D = a*n ...
        if ai == 0:
            continue
        for j, nj in enumerate(n_limbs):
            r[i + j] = r[i + j] + ai * nj
    for m in range(L + 1):                       # ... + (2^t - 1)
        cm = ((b - 1) >> (10 * m)) & 1023
        if cm:
            r[m] = r[m] + cm
    for m in range(L):                           # carry-propagate
        r[m + 1] = r[m + 1] + (r[m] >> 10)
        r[m] = r[m] & 1023
    mb, rb = divmod(t, 10)                       # k = floor(D / 2^t)
    # D < 2^t * (n+1), so the quotient is < 2^31: limbs whose shifted
    # contribution lands at bit >= 31 are zero and skipped, and a tiny q can
    # push mb past the last limb (quotient 0 -> k = 1)
    k = (r[mb] >> rb) if mb <= L else torch.zeros_like(n)
    for m in range(mb + 1, L + 1):
        shift = 10 * (m - mb) - rb
        if shift >= 31:
            break
        k = k + (r[m] << shift)
    return torch.minimum(torch.clamp(k, min=1), torch.clamp(n, min=1))


def grouped_count_extract(values: torch.Tensor, keys: torch.Tensor,
                          pivots: torch.Tensor, cap: int):
    """The plain segmented round: per (group, level) of the (G, Q) pivots,
    the (lt, eq, gt) counts of the elements with ``keys == g`` and both
    capped candidate bands, ``(counts (..., G, Q, 3), below (..., G, Q, cap),
    above (..., G, Q, cap))``.  Keys outside [0, G) are ignored.  Reads the
    data 3*G*Q times; ``kernels.ops.segmented_count_extract`` is the
    kernel-backed seam."""
    return segmented_select_ref(values, keys, pivots, cap)


def resolve(pivot: torch.Tensor, k, lt, eq, below: torch.Tensor,
            above: torch.Tensor, cap: int) -> torch.Tensor:
    """Pick the exact quantile from the pivot, the global counts and the
    merged candidate bands (below: -sentinel padded, above: +sentinel
    padded; any layout).  Stays on the device: no host sync."""
    need_left = lt - k + 1
    need_right = k - (lt + eq)
    left_val = kth_largest(below, need_left.clamp(min=1), cap)
    right_val = kth_smallest(above, need_right.clamp(min=1), cap)
    return torch.where(need_left > 0, left_val,
                       torch.where(need_right > 0, right_val, pivot))
