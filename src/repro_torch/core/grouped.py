"""Grouped exact quantiles: segmented GK Select over group keys, in PyTorch.

Counterpart of the single-process part of ``repro/core/grouped.py``.  One
job answers every group g in [0, G) at every level of ``qs``:

  phase 1  segmented sketch: per shard, one sort by (key, value) (two stable
           argsorts), then s stride samples from every group's segment;
  phase 2  per-group pivots: each merged group summary queried for its
           target ranks k_{g,q} = ceil(q * n_g), computed on the device in
           exact limb arithmetic (``local_ops.target_rank_traced``);
  phase 3  segmented count+extract for all (g, q) pivots: with
           ``block_select=True`` one Hopper launch over all shards on a CUDA
           tensor (``kernels.ops.segmented_count_extract``), else the plain
           round (3*G*Q reads);
  phase 4  resolve over the flattened (G*Q) rows (``engine.phase_resolve``).

Keys outside [0, G) belong to no group and are ignored.  A group with no
elements yields the dtype's high sentinel (+inf / int max).  NaN policy:
reject.

The sharded faces run the same phases over ``torch.distributed``
(``engine.Collectives``), every rank holding its own (values, keys) shard:
``phase_grouped_sketch`` (one all_gather per summary array, one int32
all_reduce of counts and slack), ``phase_grouped_count_extract`` (counts
all_reduce'd), then the engine's ``phase_reduce`` and ``phase_resolve``
over the flattened (G*Q) rows; ``gk_select_grouped_sharded`` is the plan
and ``distributed_quantile_grouped`` the entry point.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

from . import engine, local_ops
from .engine import Collectives
from .select import as_device_tensor
from ..kernels import ops as kernel_ops

# shards whose (key, value) sort runs at once in the sketch phase, by their
# element count: bounds the sort's scratch (indices are int64) at full size
_SKETCH_CHUNK_ELEMS = 1 << 28
_INT32_MAX = torch.iinfo(torch.int32).max


def grouped_sketch_samples(eps: float, n_local: int) -> int:
    """Per-(shard, group) sample count s = ceil(2/eps), clamped to the shard
    size: the per-group pivot rank error stays within eps*n + 1 however a
    group's mass spreads across shards."""
    if not 0.0 < eps < 1.0:
        raise ValueError(f"eps must be in (0,1), got {eps}")
    return int(min(n_local, math.ceil(2.0 / eps)))


def segmented_sketch_local(values: torch.Tensor, keys: torch.Tensor,
                           num_groups: int, s: int):
    """Per-shard segmented stride sketch of each row of (P, n_i) values and
    int32 keys: one sort by (key, value), then ``s`` stride samples from
    every group's contiguous segment.

    Returns ``(vals (P, G, s), wts (P, G, s) int32, counts (P, G) int32,
    slack (P, G) int32)``.  Sample t of group g is the element of group rank
    min((t+1)*m_g, L_g) with m_g = ceil(L_g / s); its weight is the rank gap
    to the previous sample; slack is m_g - 1 for a non-empty group."""
    n_i = values.shape[-1]
    G = num_groups
    dev = values.device
    gids = torch.arange(G + 1, dtype=torch.int32, device=dev)
    # lexicographic (key, value) via two stable argsorts; the second sort
    # gives the sorted keys itself
    order = local_ops.stable_argsort(values, dim=-1)
    k_o = keys.gather(-1, order)
    v_o = values.gather(-1, order)
    del order
    k_s, by_key = torch.sort(k_o, dim=-1, stable=True)
    del k_o
    v_s = v_o.gather(-1, by_key)
    del v_o, by_key

    # the keys are sorted, so group g is the run [bound_g, bound_{g+1}); keys
    # outside [0, G) lie before or after every run
    bounds = torch.searchsorted(
        k_s, gids.expand(*k_s.shape[:-1], G + 1).contiguous(),
        side="left").to(torch.int32)
    starts = bounds[..., :G]
    counts = bounds[..., 1:] - starts

    m = -torch.div(-counts, s, rounding_mode="floor")     # ceil(L/s); 0 if L==0
    t = torch.arange(1, s + 1, dtype=torch.int32, device=dev)
    r = torch.minimum(t * m.unsqueeze(-1), counts.unsqueeze(-1))   # (P, G, s)
    idx = (starts.unsqueeze(-1) + torch.clamp(r, min=1) - 1).clamp(0, n_i - 1)
    vals = v_s.gather(-1, idx.reshape(*idx.shape[:-2], -1).to(torch.int64))
    vals = vals.reshape(r.shape)
    wts = torch.diff(r, dim=-1,
                     prepend=torch.zeros_like(r[..., :1]))
    return vals, wts, counts, torch.clamp(m - 1, min=0)


def query_grouped_sketch(g_vals: torch.Tensor, g_wts: torch.Tensor,
                         slack: torch.Tensor, ks: torch.Tensor) -> torch.Tensor:
    """Per-group pivots from the merged segmented summaries: ``g_vals`` and
    ``g_wts`` (G, S), ``slack`` (G,), target ranks ``ks`` (G, Q).  The
    midpoint estimate of ``sketch.query_merged_sketch`` per group, with
    weight-0 lanes masked out of the argmin (first minimum wins).  Returns
    the (G, Q) pivots."""
    order = local_ops.stable_argsort(g_vals, dim=-1)
    v = g_vals.gather(-1, order)
    w = g_wts.gather(-1, order)
    est = torch.cumsum(w, -1, dtype=torch.int32) + (slack // 2).unsqueeze(-1)
    err = torch.where(w.unsqueeze(1) > 0,
                      (est.unsqueeze(1) - ks.unsqueeze(-1)).abs(),
                      _INT32_MAX)                               # (G, Q, S)
    return v.gather(-1, torch.argmin(err, dim=-1))


def grouped_target_ranks(n_g: torch.Tensor, qs: Sequence[float],
                         ks=None) -> torch.Tensor:
    """(G, Q) int32 target ranks from the (G,) group counts.  ``ks``
    overrides the q-derived ranks: a scalar (one rank for every group) or a
    (G,) / (G, Q) array of 1-based ranks."""
    G, Q = n_g.shape[0], len(qs)
    if ks is not None:
        ks = torch.as_tensor(ks, dtype=torch.int32, device=n_g.device)
        if ks.dim() == 0:
            return ks.expand(G, Q).clone()
        if ks.dim() == 1:
            return ks.unsqueeze(-1).expand(G, Q).clone()
        return ks.reshape(G, Q)
    return torch.stack([local_ops.target_rank_traced(n_g, q) for q in qs],
                       dim=-1)


def _sketch(values: torch.Tensor, keys: torch.Tensor, G: int, s: int):
    """``segmented_sketch_local`` of every shard, a chunk of shards at a
    time: (vals, wts, counts, slack) with the shard axis first."""
    P, n_i = values.shape
    step = max(1, _SKETCH_CHUNK_ELEMS // n_i)
    parts = [segmented_sketch_local(values[i:i + step], keys[i:i + step], G, s)
             for i in range(0, P, step)]
    return tuple(torch.cat(t, dim=0) for t in zip(*parts))


def gk_select_grouped(values, keys, qs: Sequence[float], *, num_groups: int,
                      eps: float = 0.01, block_select: bool = False, ks=None,
                      device="cuda") -> torch.Tensor:
    """Exact quantiles at every level of ``qs`` for every group id in
    [0, num_groups), from (P, n_i) values and int32 keys whose leading axis
    plays the shards.  Returns the (num_groups, len(qs)) values, each
    bit-identical to the per-group sort oracle (NaN policy: reject).

    ``block_select=True`` runs the count+extract round through the Hopper
    kernel on a CUDA tensor (one launch for all shards).  ``ks`` (a scalar,
    or one rank per group or per cell) overrides the q-derived ranks.  Host
    data goes to ``device``; tensors stay where they are."""
    values = as_device_tensor(values, device)
    keys = as_device_tensor(keys, device).to(torch.int32)
    if values.dim() != 2 or values.shape != keys.shape:
        raise ValueError("values/keys must be matching (P, n_i) arrays")
    local_ops.reject_nans(values, "gk_select_grouped")
    qs = tuple(float(q) for q in qs)
    P, n_i = values.shape
    n = P * n_i
    G, Q = int(num_groups), len(qs)
    s = grouped_sketch_samples(eps, n_i)

    vals, wts, counts, mslack = _sketch(values, keys, G, s)
    g_vals = vals.transpose(0, 1).reshape(G, -1)              # (G, P*s)
    g_wts = wts.transpose(0, 1).reshape(G, -1)
    n_g = counts.sum(0, dtype=torch.int32)
    slack = mslack.sum(0, dtype=torch.int32)
    kmat = grouped_target_ranks(n_g, qs, ks)
    pivots = query_grouped_sketch(g_vals, g_wts, slack, kmat)
    del vals, wts, g_vals, g_wts

    cap = local_ops.candidate_cap(n, eps, n_i)
    extract = (kernel_ops.segmented_count_extract if block_select
               else local_ops.grouped_count_extract)
    c, b, a = extract(values, keys, pivots, cap)
    cnt = c.sum(0, dtype=torch.int32).reshape(G * Q, 3)
    below = b.permute(1, 2, 0, 3).reshape(G * Q, P * cap)
    above = a.permute(1, 2, 0, 3).reshape(G * Q, P * cap)
    del c, b, a
    out = engine.phase_resolve(pivots.reshape(G * Q), kmat.reshape(G * Q),
                               cnt, below, above, cap)
    return out.reshape(G, Q)


# ---------------------------------------------------------------------------
# the sharded plan and its entry point
# ---------------------------------------------------------------------------


def phase_grouped_sketch(v_local: torch.Tensor, k_local: torch.Tensor, *,
                         coll: Collectives, num_groups: int, s: int):
    """Action 1, segmented: one (key, value) sort of this rank's shard, one
    all_gather for each of the G summaries' values and weights, one int32
    all_reduce for the group counts and slack.  Returns ``(g_vals (G,
    P*s), g_wts, n_g (G,), slack (G,))``."""
    vals, wts, counts, mslack = segmented_sketch_local(v_local, k_local,
                                                       num_groups, s)
    G = num_groups
    g_vals = coll.all_gather(vals).transpose(0, 1).reshape(G, -1)
    g_wts = coll.all_gather(wts).transpose(0, 1).reshape(G, -1)
    sums = coll.all_reduce(torch.stack([counts, mslack]), "sum")
    return g_vals, g_wts, sums[0], sums[1]


def phase_grouped_count_extract(v_local: torch.Tensor, k_local: torch.Tensor,
                                pivots: torch.Tensor, cap: int, *,
                                coll: Collectives, segmented_fn=None):
    """Actions 2+3's per-shard work for all (G, Q) pivots, counts
    all_reduce'd.  ``segmented_fn`` ``(values, keys, pivots, cap) ->
    (counts (G, Q, 3), below (G, Q, cap), above (G, Q, cap))``
    (``kernels.ops.make_segmented_fn``: one ``segmented_select`` launch on
    a CUDA shard); the plain round reads the shard 3*G*Q times."""
    fn = segmented_fn or local_ops.grouped_count_extract
    c_local, below, above = fn(v_local, k_local, pivots, cap)
    return coll.all_reduce(c_local, "sum"), below, above


def gk_select_grouped_sharded(v_local: torch.Tensor, k_local: torch.Tensor,
                              *, qs: Sequence[float], num_groups: int,
                              eps: float, coll: Collectives,
                              reduce_strategy: str = "tree",
                              segmented_fn=None, ks=None, pivots=None,
                              cap: int = None) -> torch.Tensor:
    """Exact quantiles at every level of ``qs`` for every group id in
    [0, num_groups) from one sharded job: the (G, Q) values, replicated.

    ``pivots`` (G x Q values) runs the job warm, with no sketch phase; warm
    callers pass ``ks`` (the target ranks: group counts are caller-side
    state) and should size ``cap`` from their tracked rank bound."""
    n_local = v_local.shape[0]
    n = n_local * coll.size
    G, Q = num_groups, len(qs)
    if pivots is not None:
        if ks is None:
            raise ValueError("warm grouped path needs ks alongside pivots")
        kmat = grouped_target_ranks(
            torch.zeros((G,), dtype=torch.int32, device=v_local.device), qs,
            ks)
        pivots = engine.as_like(pivots, v_local).reshape(G, Q)
    else:
        s = grouped_sketch_samples(eps, n_local)
        g_vals, g_wts, n_g, slack = phase_grouped_sketch(
            v_local, k_local, coll=coll, num_groups=G, s=s)
        kmat = grouped_target_ranks(n_g, qs, ks)
        pivots = query_grouped_sketch(g_vals, g_wts, slack, kmat)
        del g_vals, g_wts

    cap = cap if cap is not None else local_ops.candidate_cap(n, eps, n_local)
    counts, below, above = phase_grouped_count_extract(
        v_local, k_local, pivots, cap, coll=coll, segmented_fn=segmented_fn)
    below, above = engine.phase_reduce(
        below.reshape(G * Q, -1), above.reshape(G * Q, -1), coll=coll,
        strategy=reduce_strategy)
    out = engine.phase_resolve(pivots.reshape(G * Q), kmat.reshape(G * Q),
                               counts.reshape(G * Q, 3), below, above, cap)
    return out.reshape(G, Q)


def distributed_quantile_grouped(values, keys, qs: Sequence[float], *,
                                 num_groups: int, group=None,
                                 eps: float = 0.01,
                                 reduce_strategy: str = "tree",
                                 fused: bool = False, ks=None,
                                 check_nans: bool = True, pivots=None,
                                 cap: int = None,
                                 device="cuda") -> torch.Tensor:
    """Exact per-group quantiles over the ranks of ``group``: each rank
    holds flat ``values`` and ``keys`` of one length; every rank gets the
    (num_groups, len(qs)) values, each (group, level) cell bit-identical
    to the per-group sort oracle.  ``fused=True`` runs the count+extract
    round through ``segmented_select`` (one launch per CUDA shard).
    ``pivots``/``cap`` with ``ks`` run the warm job.  NaN policy: reject;
    ``check_nans=False`` hands unchecked values straight to the round,
    whose kernel and plain version count a NaN on no side.  Host data goes
    to ``device``; tensors stay where they are."""
    qs = tuple(float(q) for q in qs)
    if not qs:
        raise ValueError("qs must name at least one quantile level")
    if num_groups < 1:
        raise ValueError(f"num_groups must be >= 1, got {num_groups}")
    values = as_device_tensor(values, device)
    keys = as_device_tensor(keys, device)
    coll = Collectives(group)
    ok = values.dim() == 1 and keys.shape == values.shape
    engine.check_shards(
        coll, values, "distributed_quantile_grouped",
        problem=None if ok else "values/keys must be equal-length flat "
                                "shards",
        check_nans=check_nans)
    return gk_select_grouped_sharded(
        values, keys.to(torch.int32), qs=qs, num_groups=int(num_groups),
        eps=eps, coll=coll, reduce_strategy=reduce_strategy,
        segmented_fn=kernel_ops.make_segmented_fn() if fused else None,
        ks=ks, pivots=pivots, cap=cap)
