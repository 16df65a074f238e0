"""The engine's phases and plans, in PyTorch, over ``torch.distributed``.

Counterpart of ``repro/core/engine.py``.  The port is SPMD, as ``shard_map``
is: every rank of a process group calls a plan with its own shard (a 1-D
tensor) and gets the replicated answer back.  ``Collectives`` wraps the
group and plays the role of the mesh axis:

  phase_sketch        per-shard stride-m summary -> all_gather
  phase_pivot         replicated merged-summary query for Q target ranks
  phase_count         one pivot's 3-way counts, all_reduce'd (or gathered)
  phase_count_extract 3-way counts + both capped candidate bands for all Q
                      pivots (one Hopper launch on a CUDA shard with
                      ``fused_fn``), counts all_reduce'd in int32
  phase_reduce        candidate buffers across ranks: generalized butterfly
                      (``tree_reduce_candidates``) or capped all_gather
  phase_resolve       rank arithmetic -> the exact values (no collective)

The plans: ``gk_select_sharded`` (faithful one-sided, speculative or fused),
``gk_select_multi_sharded`` (cold, or warm from given ``pivots``/``cap``),
``approx_quantile_sharded``, ``count_discard_sharded`` (AFS / Jeffers, a
host loop) and ``full_sort_sharded`` (PSRS).  ``core.grouped`` adds the
segmented plan over the same reduce and resolve; ``core.distributed`` holds
the entry points.  Each answer is bit-identical to the JAX plan's on the
same shards.
"""
from __future__ import annotations

import math
import threading
import time
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from . import local_ops
from .select import as_device_tensor
from .sketch import local_sample_sketch, query_merged_sketch, sample_sketch_params
from ..kernels.ref import _capped_band, _sentinels

# ---------------------------------------------------------------------------
# the collective layer
# ---------------------------------------------------------------------------

# Collective accounting, ticked by every ``Collectives`` call, as
# ``kernels.ops`` counts full reads: calls by kind, the payload bytes this
# rank handed over, and the copies a gloo group makes of CUDA tensors
# through host memory (count, bytes, host seconds).  Lock-guarded.
_KINDS = ("all_gather", "all_reduce", "ppermute", "all_to_all")
_COLLECTIVES = dict.fromkeys(_KINDS + ("bytes", "host_copies",
                                       "host_copy_bytes"), 0)
_COLLECTIVES["host_copy_s"] = 0.0
_COLLECTIVES_LOCK = threading.Lock()


def reset_collectives() -> None:
    """Zero the collective counters."""
    with _COLLECTIVES_LOCK:
        for name in _COLLECTIVES:
            _COLLECTIVES[name] = 0 if name != "host_copy_s" else 0.0


def collectives() -> dict:
    """The collective counters since the last reset: calls of each kind,
    ``bytes`` (payload this rank handed to them), ``host_copies``,
    ``host_copy_bytes`` and ``host_copy_s`` (CUDA tensors copied through
    host memory for a gloo group, and the host time those copies took)."""
    with _COLLECTIVES_LOCK:
        return dict(_COLLECTIVES)


def _tick(kind: str, nbytes: int) -> None:
    with _COLLECTIVES_LOCK:
        _COLLECTIVES[kind] += 1
        _COLLECTIVES["bytes"] += nbytes


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


class Collectives:
    """A ``torch.distributed`` process group as the engine's mesh axis.

    ``rank`` and ``size`` are the group's; ``all_gather``, ``all_reduce``,
    ``ppermute`` and ``all_to_all`` return new tensors on the input's device
    and count themselves (``collectives()``).  On a gloo group a CUDA
    tensor goes through host memory (gloo carries CUDA tensors for
    all_reduce and broadcast only), and the counters report each copy; on
    an NCCL group CUDA tensors pass as they are.  The backend is the one
    the caller created the group with: this layer never switches it."""

    def __init__(self, group=None):
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self._via_host = dist.get_backend(group) == "gloo"

    def _peer(self, r: int) -> int:
        return r if self.group is None else dist.get_global_rank(self.group, r)

    def _copy(self, x: torch.Tensor, device) -> torch.Tensor:
        t0 = time.perf_counter()
        out = x.to(device)
        with _COLLECTIVES_LOCK:
            _COLLECTIVES["host_copies"] += 1
            _COLLECTIVES["host_copy_bytes"] += x.nbytes
            _COLLECTIVES["host_copy_s"] += time.perf_counter() - t0
        return out

    def _wire(self, x: torch.Tensor) -> torch.Tensor:
        """x as the backend takes it: contiguous, on the host for gloo."""
        x = x.contiguous()
        return self._copy(x, "cpu") if self._via_host and x.is_cuda else x

    def _back(self, w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        return w if w.device == like.device else self._copy(w, like.device)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's x stacked along a new leading axis: (size, *x.shape)."""
        w = self._wire(x)
        parts = [torch.empty_like(w) for _ in range(self.size)]
        dist.all_gather(parts, w, group=self.group)
        _tick("all_gather", x.nbytes)
        return self._back(torch.stack(parts), x)

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Elementwise ``op`` ("sum", "max" or "min") of every rank's x."""
        w = self._wire(x).reshape(-1)
        if w.data_ptr() == x.data_ptr():
            w = w.clone()                 # the collective works in place
        dist.all_reduce(w, op=_OPS[op], group=self.group)
        _tick("all_reduce", x.nbytes)
        return self._back(w.reshape(x.shape), x)

    def ppermute(self, x: torch.Tensor, pairs) -> torch.Tensor:
        """``jax.lax.ppermute``: each (src, dst) pair sends src's x to dst.
        A rank that receives nothing (it only sends, or takes part in no
        pair) gets zeros.  Every rank calls it with the same pairs."""
        pairs = [(int(s), int(d)) for s, d in pairs]
        srcs, dsts = [s for s, _ in pairs], [d for _, d in pairs]
        if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
            raise ValueError(f"ppermute pairs are not a permutation: {pairs}")
        to = [d for s, d in pairs if s == self.rank]
        frm = [s for s, d in pairs if d == self.rank]
        _tick("ppermute", x.nbytes if to else 0)
        if to and frm and to[0] == self.rank:
            return x.clone()
        ops, buf = [], None
        if to:
            ops.append(dist.P2POp(dist.isend, self._wire(x),
                                  self._peer(to[0]), self.group))
        if frm:
            dev = "cpu" if self._via_host else x.device
            buf = torch.empty(x.shape, dtype=x.dtype, device=dev)
            ops.append(dist.P2POp(dist.irecv, buf, self._peer(frm[0]),
                                  self.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return torch.zeros_like(x) if buf is None else self._back(buf, x)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """``jax.lax.all_to_all`` of a (size, ...) x split and concatenated
        along axis 0: row j of the result is rank j's row ``rank``."""
        if x.shape[0] != self.size:
            raise ValueError(f"all_to_all wants {self.size} rows, got "
                             f"{tuple(x.shape)}")
        w = self._wire(x)
        out = torch.empty_like(w)
        dist.all_to_all_single(out, w, group=self.group)
        _tick("all_to_all", x.nbytes)
        return self._back(out, x)


def check_shards(coll: Collectives, x: torch.Tensor, where: str, *,
                 problem: str = None, check_nans: bool = False) -> None:
    """The entry points' checks, agreed in one all_reduce (max) so that
    every rank raises together: a rank that raised alone would leave the
    others waiting in their next collective.  Raises ``ValueError`` if any
    rank reports ``problem`` (a malformed shard), if the ranks' shard
    lengths differ (the JAX entry points' ``size % shards``), or, with
    ``check_nans``, if any rank's float shard holds a NaN (NaN policy:
    reject; one extra read and a host sync)."""
    n = x.numel()
    nan = check_nans and x.is_floating_point() and bool(torch.isnan(x).any())
    flags = torch.tensor([n, -n, problem is not None, nan], dtype=torch.int64,
                         device=x.device)
    most, neg_least, bad, any_nan = coll.all_reduce(flags, "max").tolist()
    if bad:
        raise ValueError(f"{where}: "
                         f"{problem or 'a shard on another rank is malformed'}")
    if most != -neg_least:
        raise ValueError(f"{where}: shard lengths differ across ranks "
                         f"({-neg_least} to {most}) — pad first")
    if any_nan:
        raise ValueError(
            f"{where}: input contains NaN — quantiles are undefined over a "
            f"non-total order (NaN policy: reject)")


def tree_reduce_candidates(buf: torch.Tensor, coll: Collectives,
                           keep_largest: bool) -> torch.Tensor:
    """Butterfly reduction of a fixed-capacity candidate buffer across the
    ranks, for ANY rank count: every step merges two buffers along the last
    axis and keeps the ``cap`` best; all ranks end with the globally best
    cap candidates.  Leading axes (the Q levels) ride along.

    As the JAX plan (DESIGN.md §5), around p2, the largest power of two
    <= P: the r = P - p2 extra ranks fold their buffers into ranks 0..r-1;
    log2(p2) XOR steps over ranks 0..p2-1, ranks >= p2 masking what they
    got (zeros) to the identity sentinel; ranks 0..r-1 hand the result
    back.  The merge is JAX's: the cap largest by the integer total-order
    key (``lax.top_k``'s order: -0.0 below +0.0), and for the smallest the
    same of the negated values, negated back (``-top_k(-both)``: int32
    negation wraps, so an int32 minimum ranks as the largest there too)."""
    cap = buf.shape[-1]
    P = coll.size
    if P <= 1:
        return buf
    lo, hi = _sentinels(buf.dtype, buf.device)
    sent_buf = (lo if keep_largest else hi).expand(buf.shape)

    def merge(a, b):
        both = torch.cat([a, b], dim=-1)
        every = torch.ones(both.shape, dtype=torch.bool, device=both.device)
        if keep_largest:
            return _capped_band(both, every, cap, True)
        return -_capped_band(-both, every, cap, True)

    p2 = 1 << (P.bit_length() - 1)
    r = P - p2
    me = coll.rank
    if r:
        other = coll.ppermute(buf, [(p2 + i, i) for i in range(r)])
        buf = merge(buf, other if me < r else sent_buf)
    for j in range(p2.bit_length() - 1):
        d = 1 << j
        other = coll.ppermute(buf, [(i, i ^ d) for i in range(p2)])
        buf = merge(buf, sent_buf if r and me >= p2 else other)
    if r:
        other = coll.ppermute(buf, [(i, p2 + i) for i in range(r)])
        if me >= p2:
            buf = other
    return buf


def gather_candidates(buf: torch.Tensor, coll: Collectives) -> torch.Tensor:
    """Flat all_gather alternative: a (..., cap) buffer gathers to
    (..., P*cap), rank-major along the last axis."""
    g = coll.all_gather(buf).movedim(0, -2)          # (*lead, P, cap)
    return g.reshape(*g.shape[:-2], -1)


def _pmax_pair(priority: torch.Tensor, value: torch.Tensor,
               coll: Collectives) -> torch.Tensor:
    """Value attached to the max priority across the ranks: the owner is
    the lowest rank holding the max priority, and its value travels
    through a one-hot sum (value + P-1 zeros), exact for every dtype."""
    gp = coll.all_reduce(priority, "max")
    me = torch.tensor(coll.rank, dtype=torch.int32, device=priority.device)
    owner = coll.all_reduce(torch.where(priority == gp, me, 1 << 30), "min")
    return coll.all_reduce(torch.where(owner == me, value,
                                       torch.zeros_like(value)), "sum")


# ---------------------------------------------------------------------------
# phase functions
# ---------------------------------------------------------------------------


def phase_sketch(x_local: torch.Tensor, *, coll: Collectives, n: int,
                 eps: float):
    """Action 1 (collect sketches): this shard's sorted stride-m summary,
    all_gather'd so that every rank holds the merged summary.  Returns
    ``(g_vals, g_wts, m)``."""
    m, s = sample_sketch_params(n, x_local.shape[0], eps, coll.size)
    vals, weights = local_sample_sketch(x_local, m, s)
    g_vals = coll.all_gather(vals).reshape(-1)
    g_wts = coll.all_gather(weights).reshape(-1)
    return g_vals, g_wts, m


def phase_pivot(g_vals: torch.Tensor, g_wts: torch.Tensor, ks: torch.Tensor,
                *, num_shards: int, m: int) -> torch.Tensor:
    """The (Q,) pivots for the target ranks ``ks`` from the replicated
    merged summary; no collective."""
    return query_merged_sketch(g_vals, g_wts, ks, num_shards, m)


def phase_count(x_local: torch.Tensor, pivot, *, coll: Collectives,
                count3_fn=None, collect: str = "psum") -> torch.Tensor:
    """Action 2 for one pivot: this shard's int32 (lt, eq, gt) combined
    across ranks by all_reduce ("psum", AFS / treeReduce) or all_gather
    and an int32 sum (Jeffers / collect)."""
    c = (count3_fn or local_ops.count3)(x_local, pivot)
    if collect == "psum":
        return coll.all_reduce(c, "sum")
    return coll.all_gather(c).sum(0, dtype=torch.int32)


def phase_count_extract(x_local: torch.Tensor, pivots: torch.Tensor, cap: int,
                        *, coll: Collectives, fused_fn=None,
                        count_extract_fn=None):
    """Actions 2+3's per-shard work: counts (Q, 3) and both capped bands
    (Q, cap) for every pivot of the (Q,) vector; the counts ride one int32
    all_reduce.  ``fused_fn`` ``(x, pivots, cap) -> (counts, below,
    above)`` (``kernels.ops.make_fused_multi_fn``: one Hopper launch for
    all Q pivots on a CUDA shard); else ``count_extract_fn`` (default
    ``local_ops.fused_count_extract``) once per pivot."""
    if fused_fn is not None:
        c_local, below, above = fused_fn(x_local, pivots, cap)
    else:
        one = count_extract_fn or local_ops.fused_count_extract
        outs = [one(x_local, pivots[i], cap) for i in range(pivots.shape[0])]
        c_local, below, above = (torch.stack(t) for t in zip(*outs))
    return coll.all_reduce(c_local, "sum"), below, above


def phase_reduce(below: torch.Tensor, above: torch.Tensor, *,
                 coll: Collectives, strategy: str = "tree"):
    """Action 3 (treeReduce candidates): both (Q, cap) buffers cross the
    ranks in one butterfly each, or one capped all_gather each
    (strategy="all_gather")."""
    if strategy == "tree":
        return (tree_reduce_candidates(below, coll, keep_largest=True),
                tree_reduce_candidates(above, coll, keep_largest=False))
    return gather_candidates(below, coll), gather_candidates(above, coll)


def phase_resolve(pivots: torch.Tensor, ks: torch.Tensor, counts: torch.Tensor,
                  below: torch.Tensor, above: torch.Tensor,
                  cap: int) -> torch.Tensor:
    """Final rank arithmetic (paper Steps 5+9) for each of R rows: pivots
    (R,), target ranks (R,), global counts (R, 3), merged candidate bands
    (R, C) each.  Row r is ``local_ops.resolve`` of its own row, bit for
    bit; all rows sort in one call.  No collective."""
    lt, eq = counts[:, 0], counts[:, 1]
    need_left = lt - ks + 1
    need_right = ks - (lt + eq)

    def kth(cands: torch.Tensor, k: torch.Tensor, largest: bool):
        srt = local_ops.stable_sort(cands, dim=-1)
        if largest:
            srt = srt.flip(-1)
        idx = (k.clamp(min=1) - 1).clamp(0, srt.shape[-1] - 1)
        return srt.gather(-1, idx.to(torch.int64).unsqueeze(-1)).squeeze(-1)

    left_val = kth(below, need_left, largest=True)
    right_val = kth(above, need_right, largest=False)
    return torch.where(need_left > 0, left_val,
                       torch.where(need_right > 0, right_val, pivots))


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------


def as_like(a, x: torch.Tensor) -> torch.Tensor:
    """Caller-held values (a tensor, numpy incl. ml_dtypes bfloat16, or a
    sequence) as a tensor of x's dtype on x's device."""
    if not isinstance(a, torch.Tensor):
        a = as_device_tensor(np.asarray(a), x.device)
    return a.to(device=x.device, dtype=x.dtype)


def gk_select_multi_sharded(x_local: torch.Tensor, *, qs: Sequence[float],
                            eps: float, coll: Collectives,
                            reduce_strategy: str = "tree", fused_fn=None,
                            count_extract_fn=None, pivots=None,
                            cap: int = None) -> torch.Tensor:
    """Q quantiles from one sharded job: phase_sketch -> phase_pivot ->
    phase_count_extract -> phase_reduce -> phase_resolve.  Returns the (Q,)
    exact values, replicated on every rank.

    ``pivots`` (Q values) runs the job warm: the sketch phase, the only one
    that sorts the shard, is skipped.  ``cap`` overrides the eps-derived
    candidate capacity (warm callers size it from their rank bound)."""
    n_local = x_local.shape[0]
    n = n_local * coll.size
    ks = torch.tensor([local_ops.target_rank(n, q) for q in qs],
                      dtype=torch.int32, device=x_local.device)
    if pivots is None:
        g_vals, g_wts, m = phase_sketch(x_local, coll=coll, n=n, eps=eps)
        pivots = phase_pivot(g_vals, g_wts, ks, num_shards=coll.size, m=m)
    else:
        pivots = as_like(pivots, x_local).reshape(len(qs))
    if cap is None:
        cap = local_ops.candidate_cap(n, eps, n_local)
    counts, below, above = phase_count_extract(
        x_local, pivots, cap, coll=coll, fused_fn=fused_fn,
        count_extract_fn=count_extract_fn)
    below, above = phase_reduce(below, above, coll=coll,
                                strategy=reduce_strategy)
    return phase_resolve(pivots, ks, counts, below, above, cap)


def gk_select_sharded(x_local: torch.Tensor, *, q: float, eps: float,
                      coll: Collectives, speculative: bool = False,
                      reduce_strategy: str = "tree", count3_fn=None,
                      fused_fn=None) -> torch.Tensor:
    """GK Select over the ranks: the exact quantile as a 0-d tensor,
    replicated.  The faithful plan counts (``count3_fn``, e.g.
    ``kernels.ops.make_count3_fn()``), reads the rank gap's sign on the
    host and extracts one side only, sign-folded so that one "above"
    extraction serves both.  ``speculative=True`` or ``fused_fn`` (``(x,
    pivot, cap) -> (counts, below, above)``) is the Q = 1 case of the multi
    plan."""
    n_local = x_local.shape[0]
    n = n_local * coll.size
    k = local_ops.target_rank(n, q)
    count3 = count3_fn or local_ops.count3

    if speculative or fused_fn is not None:
        multi_fused = None
        if fused_fn is not None:
            def multi_fused(x, pivots, cap_):
                c, b, a = fused_fn(x, pivots[0], cap_)
                return c[None], b[None], a[None]

        def count_extract(x, pivot_, cap_):
            return (count3(x, pivot_),
                    local_ops.extract_below(x, pivot_, cap_),
                    local_ops.extract_above(x, pivot_, cap_))

        return gk_select_multi_sharded(
            x_local, qs=(q,), eps=eps, coll=coll,
            reduce_strategy=reduce_strategy, fused_fn=multi_fused,
            count_extract_fn=count_extract)[0]

    g_vals, g_wts, m = phase_sketch(x_local, coll=coll, n=n, eps=eps)
    kt = torch.tensor([k], dtype=torch.int32, device=x_local.device)
    pivot = phase_pivot(g_vals, g_wts, kt, num_shards=coll.size, m=m)[0]
    cap = local_ops.candidate_cap(n, eps, n_local)

    lt, eq, _ = phase_count(x_local, pivot, coll=coll,
                            count3_fn=count3_fn).tolist()
    need_left = lt - k + 1
    need_right = k - (lt + eq)
    go_left = need_left > 0

    # the left side negated: "smallest above -pivot" == "largest below
    # pivot", so one extraction of cap lanes serves either side
    y = -x_local if go_left else x_local
    cand = local_ops.extract_above(y, -pivot if go_left else pivot, cap)
    if reduce_strategy == "tree":
        cand = tree_reduce_candidates(cand, coll, keep_largest=False)
    else:
        cand = gather_candidates(cand, coll)
    kth = local_ops.kth_smallest(cand, max(need_left if go_left
                                           else need_right, 1), cap)
    if need_left <= 0 and need_right <= 0:
        return pivot
    return -kth if go_left else kth


def approx_quantile_sharded(x_local: torch.Tensor, *, q: float, eps: float,
                            coll: Collectives) -> torch.Tensor:
    """GK Sketch plan (Spark approxQuantile): phase_sketch + phase_pivot."""
    n = x_local.shape[0] * coll.size
    kt = torch.tensor([local_ops.target_rank(n, q)], dtype=torch.int32,
                      device=x_local.device)
    g_vals, g_wts, m = phase_sketch(x_local, coll=coll, n=n, eps=eps)
    return phase_pivot(g_vals, g_wts, kt, num_shards=coll.size, m=m)[0]


def count_discard_sharded(x_local: torch.Tensor, *, q: float,
                          coll: Collectives, max_rounds: int = 128,
                          seed: int = 0,
                          collect_counts: bool = False) -> torch.Tensor:
    """AFS (``collect_counts=False``: counts by all_reduce) / Jeffers
    (``True``: by all_gather) plan: O(log n) rounds of a host loop, one
    count collective and one distributed reservoir pick a round.

    Picks are drawn strictly inside the open band (lo, hi), so a value
    equal to a dtype extreme is never a pivot; when the target lands on one
    the band empties, and the loop ends on the boundary whose side rank
    says holds rank k.  The band's population comes from carried rank
    masses (#{x <= lo}, #{x < hi}), updated from the counts each round.
    The random picks come from a ``torch.Generator`` seeded from
    (seed, rank): rounds differ from the JAX plan's threefry stream, the
    answer does not."""
    n = x_local.shape[0] * coll.size
    k = local_ops.target_rank(n, q)
    lo, hi = _sentinels(x_local.dtype, x_local.device)
    collect = "all_gather" if collect_counts else "psum"
    gen = torch.Generator(device=x_local.device)
    gen.manual_seed((int(seed) * 1_000_003 + coll.rank) % (1 << 63))

    def candidate(lo_, hi_):
        pri = torch.rand(x_local.shape, generator=gen, device=x_local.device)
        active = (x_local > lo_) & (x_local < hi_)
        pri = torch.where(active, pri, -1.0)
        i = torch.argmax(pri)
        return _pmax_pair(pri[i], x_local[i], coll)

    # elements equal to a sentinel boundary are never active; count them
    # once so that an emptied band resolves to the right boundary
    c_lo = local_ops.count3(x_local, lo)
    c_hi = local_ops.count3(x_local, hi)
    n_le_lo, n_lt_hi = coll.all_reduce(
        torch.stack([c_lo[0] + c_lo[1], c_hi[0]]), "sum").tolist()

    lo_, hi_ = lo, hi
    pivot = ans = candidate(lo_, hi_)
    for _ in range(max_rounds):
        if n_lt_hi - n_le_lo == 0:                    # the band is empty
            ans = lo_ if k <= n_le_lo else hi_
            break
        lt, eq, _ = phase_count(x_local, pivot, coll=coll,
                                collect=collect).tolist()
        if lt < k <= lt + eq:
            ans = pivot
            break
        if k <= lt:
            hi_, n_lt_hi = pivot, lt
        else:
            lo_, n_le_lo = pivot, lt + eq
        pivot = candidate(lo_, hi_)
    return ans


def full_sort_sharded(x_local: torch.Tensor, *, q: float, coll: Collectives,
                      capacity_factor: float = 2.0) -> torch.Tensor:
    """PSRS / Spark range-partition sort: the O(n) full-shuffle baseline.

    Per-shard regular samples -> replicated splitters -> capacity-lane
    all_to_all shuffle -> local sort -> the rank's owner ships its value.
    Lanes are high-sentinel padded; a bucket past its capacity drops its
    overflow and its last lane holds the sentinel, as the JAX scatter
    leaves it.  If the drop takes rank k, no rank owns it and the answer
    is the high sentinel."""
    n_local = x_local.shape[0]
    P = coll.size
    n = n_local * P
    k = local_ops.target_rank(n, q)
    dev = x_local.device
    _, hi = _sentinels(x_local.dtype, dev)

    r = min(n_local, 64)
    xs = local_ops.stable_sort(x_local)
    stride = max(1, n_local // r)
    samples = xs[::stride][:r]
    all_samples = local_ops.stable_sort(coll.all_gather(samples).reshape(-1))
    step = max(1, all_samples.numel() // P)
    splitters = all_samples[step::step][: P - 1].contiguous()

    bucket = torch.searchsorted(splitters, x_local, right=True)
    cap = int(min(n_local, math.ceil(capacity_factor * n_local / P)))
    order = torch.sort(bucket, stable=True).indices
    xb, bb = x_local[order], bucket[order]
    start = torch.searchsorted(bb, torch.arange(P, device=dev))
    pos = torch.arange(n_local, device=dev) - start[bb]
    valid = pos < cap
    send = hi.expand(P, cap).clone()
    send[bb[valid], pos[valid]] = xb[valid]
    per_bucket = torch.bincount(bb, minlength=P)
    send[per_bucket > cap, cap - 1] = hi
    sent = torch.bincount(bb[valid], minlength=P).to(torch.int32)

    recv = coll.all_to_all(send).reshape(-1)
    local_sorted = local_ops.stable_sort(recv)      # sentinels sort last

    counts_all = coll.all_reduce(sent, "sum")       # (P,) per bucket
    below = torch.cumsum(counts_all, 0, dtype=torch.int32) - counts_all
    k_local = k - below[coll.rank]
    have = (k_local >= 1) & (k_local <= counts_all[coll.rank])
    val = local_sorted[(k_local - 1).clamp(0, recv.numel() - 1)]
    out = coll.all_reduce(torch.where(have, val, torch.zeros_like(val)), "sum")
    owned = coll.all_reduce(have.to(torch.int32), "sum")
    return torch.where(owned > 0, out, hi)
