"""GK Select over pytrees of tensors, and per-channel exact quantiles.

Counterpart of ``repro/optim/quantile_ops.py``.  A pytree is a nested dict,
list or tuple of tensors (``repro_torch.pytree``); its leaves are taken in
the JAX order.

``pytree_exact_quantile`` treats every chunk of every leaf as one GK Select
"partition": per-chunk sample sketches are built leaf by leaf (no
concatenation of the data), merged once, and the count and extract phases
run per leaf and combine.  ``pytree_radix_quantile`` is the radix search
over the sortable-uint32 keys, one leaf's at a time, with exact two-limb
ranks.
``channelwise_exact_quantile`` answers C channels (dense or ragged) as one
grouped GK Select job.  Every answer is the sort oracle's, bit for bit.
"""
from __future__ import annotations

import functools
import math
from typing import Callable

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate

from ..core import local_ops
from ..core.grouped import gk_select_grouped
from ..core.sketch import local_sample_sketch
from ..dtensor import meta_if_fake
from ..kernels.ref import from_sortable_u32, to_sortable_u32, u32_as_int64
from ..pytree import leaves as tree_leaves, tree_map

__all__ = ["pytree_exact_quantile", "pytree_radix_quantile",
           "channelwise_exact_quantile", "quantile_clip_by_value"]


def _leaf_chunks(leaf: torch.Tensor, chunk: int):
    """Flatten a leaf to f32 and pad it with +inf to (P_l, chunk)."""
    flat = leaf.reshape(-1).to(torch.float32)
    n = flat.numel()
    P = max(1, -(-n // chunk))
    pad = P * chunk - n
    if pad:
        flat = torch.cat([flat, flat.new_full((pad,), math.inf)])
    return flat.reshape(P, chunk), n, pad


def pytree_exact_quantile(tree, q: float, *, eps: float = 1e-3,
                          chunk: int = 1 << 16,
                          transform: Callable = torch.abs) -> torch.Tensor:
    """Exact q-quantile of transform(leaf values) over every element of the
    pytree, as a 0-d f32 tensor on the leaves' device.  Pad lanes are +inf
    and are accounted out of the target rank."""
    leaves = [transform(l) for l in tree_leaves(tree)]
    if not leaves:
        raise ValueError("empty pytree")
    sizes = [int(l.numel()) for l in leaves]
    n_total = sum(sizes)
    k = local_ops.target_rank(n_total, q)

    # ---- Phase 1: per-chunk sketches, merged across all leaves ----
    all_vals, all_wts = [], []
    total_slack = 0
    chunk_meta = []
    for leaf, n_l in zip(leaves, sizes):
        parts, n, pad = _leaf_chunks(leaf, chunk)
        P_l, n_i = parts.shape
        m = max(1, int(math.floor(eps * max(1, n_l) / P_l)))
        m = min(m, n_i)
        s = int(math.ceil(n_i / m))
        v, w = local_sample_sketch(parts, m, s)
        # padded +inf lanes inflate the top samples' weights: zero them
        w = torch.where(torch.isinf(v), 0, w)
        all_vals.append(v.reshape(-1))
        all_wts.append(w.reshape(-1))
        total_slack += P_l * m
        chunk_meta.append(parts)
    values = torch.cat(all_vals)
    weights = torch.cat(all_wts)
    order = local_ops.stable_argsort(values)
    v_s, w_s = values[order], weights[order]
    # int32 rank arithmetic, as the reference's
    cum = torch.cumsum(w_s, 0, dtype=torch.int32)
    est = cum + (total_slack // 2)
    pivot = v_s[torch.argmin((est - k).abs())]

    # ---- Phase 2: counts (pad lanes are +inf: never < or == the pivot,
    # which cannot be +inf since +inf samples weigh 0) ----
    lt = torch.zeros((), dtype=torch.int32, device=pivot.device)
    eq = torch.zeros_like(lt)
    for parts in chunk_meta:
        flat = parts.reshape(-1)
        lt = lt + (flat < pivot).sum(dtype=torch.int32)
        eq = eq + (flat == pivot).sum(dtype=torch.int32)

    # ---- Phase 3: capped two-sided extraction + resolve ----
    cap_total = int(min(n_total, math.ceil(eps * n_total) + 2))
    belows, aboves = [], []
    for parts in chunk_meta:
        flat = parts.reshape(-1)
        cap_l = int(min(flat.numel(), cap_total))
        belows.append(local_ops.extract_below(flat, pivot, cap_l))
        aboves.append(local_ops.extract_above(flat, pivot, cap_l))
    kk = torch.tensor(k, dtype=torch.int32, device=pivot.device)
    return local_ops.resolve(pivot, kk, lt, eq, torch.cat(belows),
                             torch.cat(aboves), cap_total)


_RADIX_CHUNK = 1 << 20
_U32 = 0xFFFFFFFF


def pytree_radix_quantile(tree, q: float, *, passes: int = 32,
                          bits_per_pass: int = 4,
                          transform: Callable = torch.abs) -> torch.Tensor:
    """Exact q-quantile over a pytree, holding one leaf's keys at a time:
    radix search on the sortable-uint32 keys, one streaming pass per digit
    (``bits_per_pass`` bits a pass, 2^b bucket bounds against one read of
    each chunk), each pass making each leaf's keys again.  Ranks are exact
    two-limb (hi, lo) base-2^16 int32 integers, as the reference's:
    per-chunk counts stay < 2^21 and limb sums < 2^31.  A leaf longer than
    a chunk of 2^20 keys is padded to whole chunks, as the reference pads
    every leaf; a shorter one is one row of its own length (the same
    counts).  Keys are int64 (uint32 arithmetic, wrap included, masked to
    32 bits).  Returns a 0-d f32 tensor.

    DTensor leaves count on each rank's shard: the leaves split over the
    same mesh dimensions form a group, and a group's (hi, lo) pairs of
    one digit's bounds are summed
    over those dimensions in one all-reduce, so a shard replicated on
    another dimension counts once.  Every rank gets the same answer, the
    sort's of the whole tree."""
    tree_l = tree_leaves(tree)
    if not tree_l:
        raise ValueError("empty pytree")
    n_total = sum(int(l.numel()) for l in tree_l)
    k = local_ops.target_rank(n_total, q)
    groups = {}                        # split mesh dims -> (reduce, leaves)
    for l in tree_l:
        dims, local, reduce = _split_dims(l)
        groups.setdefault(dims, (reduce, []))[1].append(local)
    device = next(iter(groups.values()))[1][0].device

    def rows(l):
        """One leaf's keys as int64 rows: made again for every digit, so
        that the keys of one leaf at a time are held (a copy of every
        leaf's keys would be 12 bytes a parameter)."""
        u = u32_as_int64(to_sortable_u32(
            transform(l).to(torch.float32).reshape(-1)))
        if u.numel() <= _RADIX_CHUNK:
            return u[None]          # one row, unpadded: the same counts
        pad = (-u.numel()) % _RADIX_CHUNK
        if pad:
            # pad key 0xFFFFFFFE never satisfies (u <= mid): mid < 2^32 - 2
            u = torch.cat([u, u.new_full((pad,), 0xFFFFFFFE)])
        return u.reshape(-1, _RADIX_CHUNK)

    k_hi, k_lo = k >> 16, k & 0xFFFF

    def group_pairs(n_bounds: int, *ts):
        """(hi, lo), each (n_bounds,) int32: one group's count of keys <=
        each bound; ``ts`` holds the bounds, then the group's leaves.  All
        bounds are compared with a block of a leaf's rows at once: a
        (n_bounds, rows, chunk) mask of at most 2^23 elements or one row
        (its count takes an int32 copy of it)."""
        bounds = torch.stack(ts[:n_bounds])[:, None, None]
        hi = torch.zeros(n_bounds, dtype=torch.int32, device=bounds.device)
        lo = torch.zeros_like(hi)
        for leaf in ts[n_bounds:]:
            ch = rows(leaf)
            R = max(1, (1 << 23) // (n_bounds * ch.shape[1]))
            blocks = [(ch[r:r + R] <= bounds).sum(-1, dtype=torch.int32)
                      for r in range(0, ch.shape[0], R)]
            del ch
            c = blocks[0] if len(blocks) == 1 else torch.cat(blocks, dim=1)
            del blocks                             # c: (n_bounds, m) < 2^21
            leaf_lo = (c & 0xFFFF).sum(1, dtype=torch.int32)
            hi = hi + (c >> 16).sum(1, dtype=torch.int32) + (leaf_lo >> 16)
            lo = lo + (leaf_lo & 0xFFFF)                     # carry per leaf
        return hi, lo

    def ge_k(bounds) -> torch.Tensor:
        """(len(bounds),) bool: at least k keys <= each bound."""
        hi = torch.zeros(len(bounds), dtype=torch.int32, device=device)
        lo = torch.zeros_like(hi)
        for reduce, ls in groups.values():
            # a dry-run's fake shards count as meta tensors: the same ops
            # on the same shapes, ~25 us an op against ~0.7 ms
            g_hi, g_lo = meta_if_fake(functools.partial(
                group_pairs, len(bounds)), *bounds, *ls)
            if reduce is not None:
                # the group's pairs, carried, summed over its shards'
                # ranks: lo < 2^16 x ranks
                both = reduce(torch.stack([g_hi + (g_lo >> 16),
                                           g_lo & 0xFFFF]))
                g_hi, g_lo = both[0], both[1]
            hi, lo = hi + g_hi, lo + g_lo
        hi = hi + (lo >> 16)
        lo = lo & 0xFFFF
        return (hi > k_hi) | ((hi == k_hi) & (lo >= k_lo))

    def answer(key: torch.Tensor) -> torch.Tensor:
        bits = key.to(torch.int32).view(torch.uint32)        # wraps to 32 bits
        return from_sortable_u32(bits, torch.float32)

    if bits_per_pass == 1:
        lo = torch.zeros((), dtype=torch.int64, device=device)
        hi = torch.full((), _U32, dtype=torch.int64, device=device)
        for _ in range(passes):
            mid = lo + (hi - lo) // 2
            ge = ge_k([mid])[0]
            lo, hi = (torch.where(ge, lo, (mid + 1) & _U32),
                      torch.where(ge, mid, hi))
        return answer(lo)

    # multi-bit radix: the 2^b bucket upper bounds against the same values;
    # uint32 wraparound makes the top bucket's bound 2^32 - 1
    b = bits_per_pass
    if 32 % b:
        raise ValueError(f"bits_per_pass must divide 32, got {b}")
    nb = 1 << b
    prefix = torch.zeros((), dtype=torch.int64, device=device)
    for i in range(32 // b):
        shift = 32 - b * (i + 1)
        ge = ge_k([(prefix + (((j + 1) << shift) & _U32) - 1) & _U32
                   for j in range(nb)])                      # (nb,) bool
        digit = (~ge).sum()                                  # first ge bucket
        prefix = (prefix | (digit << shift)) & _U32
    return answer(prefix)


def _split_dims(leaf: torch.Tensor):
    """(the mesh dims a DTensor leaf is split over, its local shard, a
    function summing a tensor over those dims' ranks); a plain tensor, or
    a DTensor whole on every rank, is ((), itself, None)."""
    if not isinstance(leaf, DTensor):
        return (), leaf, None
    mesh = leaf.device_mesh
    if any(p.is_partial() for p in leaf.placements):
        raise ValueError("a leaf with pending partial sums: redistribute it "
                         "to its parameter's placements first")
    dims = tuple(i for i, p in enumerate(leaf.placements) if p.is_shard())
    if not dims:
        return (), leaf.to_local(), None
    place = [Partial() if i in dims else Replicate()
             for i in range(mesh.ndim)]

    def reduce(t: torch.Tensor) -> torch.Tensor:
        return DTensor.from_local(t, mesh, place,
                                  run_check=False).full_tensor()
    return (id(mesh), dims), leaf.to_local(), reduce


def _grouped_channel_job(values: torch.Tensor, keys: torch.Tensor,
                         num_channels: int, q: float, eps: float,
                         num_partitions: int, ks) -> torch.Tensor:
    """Flat (values, channel-id) pair -> (C,) exact per-channel quantiles as
    ONE grouped GK Select job.  The tail pad carries the out-of-range key
    ``num_channels`` so pads belong to no group and never move any rank."""
    pad = (-values.numel()) % num_partitions
    if pad:
        values = local_ops.pad_with_high_sentinel(values, num_partitions)
        keys = torch.cat([keys, keys.new_full((pad,), num_channels)])
    parts_v = values.reshape(num_partitions, -1)
    parts_k = keys.reshape(num_partitions, -1)
    return gk_select_grouped(parts_v, parts_k, (q,), num_groups=num_channels,
                             eps=eps, ks=ks)[:, 0]


def channelwise_exact_quantile(x, q: float, *, axis: int = -1,
                               eps: float = 0.01,
                               num_partitions: int = 8) -> torch.Tensor:
    """Per-channel exact q-quantile, batched into ONE grouped GK Select job.

    ``x`` is a dense tensor (channels along ``axis``, the quantile taken
    over every other axis) or a sequence of 1-D tensors (ragged channels).
    Either way one segmented job answers all channels (channel id == group
    key).  Ranks are ``local_ops.target_rank`` of each channel's true count;
    an empty ragged channel yields the dtype's high sentinel.  NaN policy:
    reject.  Returns the (C,) values on x's device."""
    if isinstance(x, (list, tuple)):
        channels = [c.reshape(-1) for c in x]
        if not channels:
            raise ValueError("need at least one channel")
        dt = functools.reduce(torch.promote_types,
                              [c.dtype for c in channels])
        lens = [int(c.numel()) for c in channels]
        device = channels[0].device
        values = torch.cat([c.to(dt) for c in channels])
        keys = torch.cat([torch.full((l,), i, dtype=torch.int32,
                                     device=device)
                          for i, l in enumerate(lens)])
        ks = tuple(local_ops.target_rank(l, q) if l else 1 for l in lens)
        return _grouped_channel_job(values, keys, len(channels), q, eps,
                                    num_partitions, ks)

    C = x.shape[axis]
    xc = torch.movedim(x, axis, 0).reshape(C, -1)
    n = xc.shape[1]
    keys = torch.arange(C, dtype=torch.int32,
                        device=x.device).repeat_interleave(n)
    return _grouped_channel_job(xc.reshape(-1), keys, C, q, eps,
                                num_partitions, local_ops.target_rank(n, q))


def quantile_clip_by_value(grads, q: float = 0.999, *, eps: float = 1e-3,
                           method: str = "radix"):
    """Clip gradient magnitudes at the *exact* q-quantile of |g| across the
    whole pytree: ``(clipped, threshold)``.  ``method="radix"`` scales to
    billions of elements; ``"gk_select"`` is the paper-faithful 3-phase
    path (right for calibration-scale n).  A 16-bit leaf is clipped in
    f32 and rounded to its dtype, as the reference's: where the threshold
    is an f32 value between two of the leaf's, a clipped value may round
    above it."""
    if method == "radix":
        thr = pytree_radix_quantile(grads, q)
    else:
        thr = pytree_exact_quantile(grads, q, eps=eps).to(torch.float32)
    thr = torch.clamp(thr, min=1e-12)

    def clip(g):
        return torch.clamp(g.to(torch.float32), -thr, thr).to(g.dtype)

    return tree_map(clip, grads), thr
