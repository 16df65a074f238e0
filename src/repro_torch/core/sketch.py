"""The quantile sketches that GK Select pivots on, in PyTorch.

Counterpart of ``repro/core/sketch.py``:

* the sample sketch: sort each shard, keep every m-th element with the
  count it covers, and query the merged samples for the pivot of rank k;
* ``SketchState``, its streaming form: a fixed-budget weighted summary that
  each batch updates by sorting the batch alone (``sketch_update``,
  ``sketch_update_batch`` for a slot table of streams), that merges
  (``sketch_merge*``) and that answers rank queries in O(s);
* ``GKSketch``, the host Greenwald-Khanna summary with Spark's head buffer
  (numpy), with ``merge_fold_left`` and ``merge_tree``.

Every sort that mirrors a ``jnp.sort``/``jnp.argsort`` goes through
``local_ops.stable_argsort`` and every integer sum stays int32, so each
state is the JAX package's bit for bit.
"""
from __future__ import annotations

import dataclasses
import math
import threading
from typing import NamedTuple, Tuple

import numpy as np
import torch

from .local_ops import stable_argsort, stable_sort
from ..kernels.ref import _sentinels

# Sketch-phase sort accounting, ticked by every code path that sorts raw
# data to build or rebuild a sketch.  Lock-guarded so that no tick is lost.
_SKETCH_SORTS = {"total": 0}
_SKETCH_SORTS_LOCK = threading.Lock()


def reset_sketch_sorts() -> None:
    """Zero the sketch-phase sort counter."""
    with _SKETCH_SORTS_LOCK:
        _SKETCH_SORTS["total"] = 0


def sketch_sorts() -> int:
    """Sketch-construction sorts dispatched since the last reset."""
    with _SKETCH_SORTS_LOCK:
        return _SKETCH_SORTS["total"]


def record_sketch_sort(n: int = 1) -> None:
    """Tick the sketch-phase sort counter.  Thread-safe."""
    with _SKETCH_SORTS_LOCK:
        _SKETCH_SORTS["total"] += n


def sample_sketch_params(n_total: int, n_local: int, eps: float,
                         num_shards: int) -> Tuple[int, int]:
    """(stride m, samples per shard s) for a target rank error eps*n: the
    summed per-shard uncertainty P*m stays <= eps*n, and s = ceil(n_local/m)
    samples cover the shard including a final partial group."""
    if not 0.0 < eps < 1.0:
        raise ValueError(f"eps must be in (0,1), got {eps}")
    m = max(1, int(math.floor(eps * n_total / max(1, num_shards))))
    m = min(m, n_local)
    s = int(math.ceil(n_local / m))
    return m, s


def local_sample_sketch(x: torch.Tensor, m: int, s: int):
    """Sorted stride-m summary of each shard along the last axis.

    Returns (values (..., s), weights (..., s) int32): sample t is the
    element of local rank min((t+1)*m, n_i); its weight is the number of
    elements it covers.  Clamped duplicates at the tail get weight 0.
    """
    n_i = x.shape[-1]
    order = stable_argsort(x, dim=-1)
    idx = torch.clamp(torch.arange(1, s + 1, device=x.device) * m - 1,
                      max=n_i - 1)
    vals = torch.gather(x, -1, order[..., idx])
    prev = torch.cat([idx.new_full((1,), -1), idx[:-1]])
    weights = (idx - prev).to(torch.int32).expand(vals.shape)
    return vals, weights


def query_merged_sketch(values: torch.Tensor, weights: torch.Tensor, k,
                        num_shards: int, m: int) -> torch.Tensor:
    """The pivot for rank k from the concatenated per-shard summaries
    (flat (P*s,)).  rank(v_t) lies in [cum_t, cum_t + P*m], so the midpoint
    estimate is within eps*n of the chosen sample's true rank.  ``k`` may be
    a (Q,) tensor of ranks: the result is then the Q pivots."""
    order = stable_argsort(values)
    v = values[order]
    cum = torch.cumsum(weights[order], 0)          # exact ranks
    est = cum + num_shards * m // 2
    k = torch.as_tensor(k, dtype=est.dtype, device=est.device)
    t = torch.argmin((est - k.unsqueeze(-1)).abs(), dim=-1)
    return v[t]


# ---------------------------------------------------------------------------
# SketchState: the incrementally maintained sample sketch of a stream
# ---------------------------------------------------------------------------

_INT32_MAX = torch.iinfo(torch.int32).max


class SketchState(NamedTuple):
    """Fixed-budget weighted quantile summary, maintained incrementally.

      values  (..., s)  sorted ascending; unused lanes carry the dtype's
                        high sentinel with weight 0
      weights (..., s)  int32 mass per sample; cumsum(weights) estimates
                        each sample's rank in the ingested multiset
      n       (...)     int32 ingested count (sum of weights)
      slack   (...)     int32 bound on how far any sample's cumulative
                        weight can undercount its true rank

    For every sample ``cum_i <= rank(v_i) <= cum_i + slack``, and adjacent
    samples are at most ``max(weights)`` apart, so a query's rank error is
    at most ``sketch_rank_bound``.  Slack composes by max, not by sum.
    Leading axes stack streams: a slot table is one ``SketchState`` whose
    leaves all carry a leading stream axis.
    """

    values: torch.Tensor
    weights: torch.Tensor
    n: torch.Tensor
    slack: torch.Tensor


def sketch_budget(eps: float) -> int:
    """Static sample budget s = clamp(ceil(16/eps), 64, 2^16) for a streamed
    rank-error target of eps*n."""
    if not 0.0 < eps < 1.0:
        raise ValueError(f"eps must be in (0,1), got {eps}")
    return int(min(1 << 16, max(64, math.ceil(16.0 / eps))))


def _high(dtype, device) -> torch.Tensor:
    return _sentinels(dtype, device)[1]


def sketch_init(budget: int, dtype=torch.float32,
                device="cuda") -> SketchState:
    """Empty stream summary with a static ``budget``-lane budget, on
    ``device`` (``"cuda"`` without a card raises)."""
    from .select import require_device
    device = require_device(device)
    i32 = dict(dtype=torch.int32, device=device)
    return SketchState(values=_high(dtype, device).expand(budget).clone(),
                       weights=torch.zeros((budget,), **i32),
                       n=torch.zeros((), **i32), slack=torch.zeros((), **i32))


def _batch_run(batch: torch.Tensor, budget: int):
    """One flat batch as a (<= budget)-sample run with exact cumulative
    ranks (stride m_b = ceil(n_b/budget)): ``(values, weights, m_b)``."""
    n_b = batch.shape[0]
    m_b = max(1, -(-n_b // budget))
    s_b = min(n_b, budget)
    vals, wts = local_sample_sketch(batch, m_b, s_b)
    return vals, wts, m_b


def _sorted_merge(v: torch.Tensor, w: torch.Tensor):
    """Both runs in one stable order along the last axis (``jnp.argsort``'s
    order: -0.0 and +0.0 tie in input order)."""
    order = stable_argsort(v)
    return v.gather(-1, order), w.gather(-1, order)


def _compress(values: torch.Tensor, weights: torch.Tensor, n: torch.Tensor,
              budget: int):
    """Re-compress merged weighted runs (last axis) to ``budget`` lanes.

    Kept samples are a subset chosen at the rank targets t_j = j*(n//s) +
    min(j, n%s); dropped mass folds into the next kept sample, so kept
    cumulative weights are exactly the input's.  int32 throughout."""
    cum = torch.cumsum(weights, -1, dtype=torch.int32)
    j = torch.arange(1, budget + 1, dtype=torch.int32, device=values.device)
    n = n.unsqueeze(-1)
    targets = j * (n // budget) + torch.minimum(j, n % budget)
    idx = torch.searchsorted(cum, targets.expand(*cum.shape[:-1], budget)
                             .contiguous(), side="left")
    idx = idx.clamp(max=values.shape[-1] - 1)
    kept_cum = cum.gather(-1, idx)
    new_w = torch.diff(kept_cum, dim=-1,
                       prepend=torch.zeros_like(kept_cum[..., :1]))
    return values.gather(-1, idx), new_w


def sketch_update(state: SketchState, batch: torch.Tensor) -> SketchState:
    """Fold one batch into one summary: sort the batch only, merge the two
    sorted runs, re-compress to the budget."""
    budget = state.values.shape[-1]
    batch = batch.reshape(-1).to(state.values.dtype)
    b_vals, b_wts, m_b = _batch_run(batch, budget)
    v, w = _sorted_merge(torch.cat([state.values, b_vals]),
                         torch.cat([state.weights, b_wts]))
    n_new = state.n + batch.shape[0]
    v, w = _compress(v, w, n_new, budget)
    # resident samples miss at most the batch's stride of new mass, batch
    # samples at most the resident summary's widest gap
    gap = state.weights.max()
    slack = torch.where(state.n > 0,
                        torch.maximum(state.slack + (m_b - 1), gap),
                        torch.full_like(state.slack, m_b - 1))
    return SketchState(values=v, weights=w, n=n_new, slack=slack)


def _batch_run_padded(batch: torch.Tensor, n_valid: torch.Tensor,
                      budget: int):
    """``_batch_run`` of each row of a sentinel-padded (..., L) batch with
    its own valid count, in a fixed ``budget`` lanes: lanes past the valid
    samples repeat the last one with weight 0."""
    xs = stable_sort(batch)
    nv = n_valid.unsqueeze(-1)
    m_b = torch.clamp(-(-nv // budget), min=1)
    t = torch.arange(1, budget + 1, dtype=torch.int32, device=batch.device)
    r = torch.minimum(t * m_b, nv)
    idx = (torch.clamp(r, min=1) - 1).clamp(0, batch.shape[-1] - 1)
    vals = xs.gather(-1, idx.to(torch.int64).expand(*xs.shape[:-1], budget))
    wts = torch.diff(r, dim=-1, prepend=torch.zeros_like(r[..., :1]))
    return vals, wts.expand(*xs.shape[:-1], budget), m_b.squeeze(-1)


def sketch_update_padded(state: SketchState, batch: torch.Tensor,
                         n_valid) -> SketchState:
    """``sketch_update`` of the first ``n_valid`` lanes of a batch whose
    other lanes hold the dtype's high sentinel.  Leading axes of ``state``,
    ``batch`` (..., L) and ``n_valid`` (...) are streams, advanced together
    in batched ops; a row with ``n_valid == 0`` is returned bit-unchanged."""
    budget = state.values.shape[-1]
    batch = batch.to(state.values.dtype)
    nv = torch.as_tensor(n_valid, dtype=torch.int32,
                         device=batch.device).expand(batch.shape[:-1])
    b_vals, b_wts, m_b = _batch_run_padded(batch, nv, budget)
    v, w = _sorted_merge(torch.cat([state.values, b_vals], -1),
                         torch.cat([state.weights, b_wts], -1))
    n_new = state.n + nv
    v, w = _compress(v, w, n_new, budget)
    gap = state.weights.max(-1).values
    slack = torch.where(state.n > 0,
                        torch.maximum(state.slack + (m_b - 1), gap), m_b - 1)
    keep = nv > 0
    return SketchState(
        values=torch.where(keep.unsqueeze(-1), v, state.values),
        weights=torch.where(keep.unsqueeze(-1), w, state.weights),
        n=torch.where(keep, n_new, state.n),
        slack=torch.where(keep, slack, state.slack))


def sketch_update_batch(states: SketchState, batches: torch.Tensor,
                        n_valid: torch.Tensor) -> SketchState:
    """Advance S streams at once: ``states`` stacked (leading axis S),
    ``batches`` (S, L) sentinel padded, ``n_valid`` (S,).  Row i equals
    ``sketch_update(states[i], batches[i, :n_valid[i]])`` bit for bit.  The
    ops are batched over S, so a tick launches the same kernels for 1
    stream as for 10^4."""
    return sketch_update_padded(states, batches, n_valid)


def sketch_merge(a: SketchState, b: SketchState) -> SketchState:
    """Merge two summaries of one budget (leading axes merge row by row):
    concatenate the sorted runs and re-compress.  Each side's samples miss
    at most the other side's widest gap, once."""
    if a.values.shape != b.values.shape:
        raise ValueError(f"sketch budgets differ: {tuple(a.values.shape)} vs "
                         f"{tuple(b.values.shape)}")
    budget = a.values.shape[-1]
    v, w = _sorted_merge(torch.cat([a.values, b.values], -1),
                         torch.cat([a.weights, b.weights], -1))
    n_new = a.n + b.n
    v, w = _compress(v, w, n_new, budget)
    gap_a = a.weights.max(-1).values
    gap_b = b.weights.max(-1).values
    slack = torch.maximum(torch.where(b.n > 0, a.slack + gap_b, a.slack),
                          torch.where(a.n > 0, b.slack + gap_a, b.slack))
    return SketchState(values=v, weights=w, n=n_new, slack=slack)


def sketch_merge_batch(a: SketchState, b: SketchState) -> SketchState:
    """Row-wise ``sketch_merge`` of two stacked summaries of one shape."""
    if a.values.shape != b.values.shape:
        raise ValueError(f"stacked sketch shapes differ: "
                         f"{tuple(a.values.shape)} vs {tuple(b.values.shape)}")
    return sketch_merge(a, b)


def sketch_merge_many(states) -> SketchState:
    """Pairwise-tree merge of any number of equally shaped stacked
    summaries; the slack grows with the tree's depth ceil(log2 K)."""
    items = list(states)
    if not items:
        raise ValueError("need at least one SketchState to merge")
    while len(items) > 1:
        nxt = [sketch_merge_batch(items[i], items[i + 1])
               for i in range(0, len(items) - 1, 2)]
        if len(items) % 2:
            nxt.append(items[-1])
        items = nxt
    return items[0]


def sketch_stack(states) -> SketchState:
    """Stack per-stream summaries of one budget into one slot table."""
    states = list(states)
    if not states:
        raise ValueError("need at least one SketchState to stack")
    return SketchState(*(torch.stack(leaves) for leaves in zip(*states)))


def sketch_unstack(stacked: SketchState):
    """Split a stacked summary back into per-stream summaries."""
    return [SketchState(*(leaf[i] for leaf in stacked))
            for i in range(stacked.values.shape[0])]


def sketch_init_stack(count: int, budget: int, dtype=torch.float32,
                      device="cuda") -> SketchState:
    """``count`` empty stream summaries as one stacked summary."""
    one = sketch_init(budget, dtype, device)
    return SketchState(*(leaf.expand((count,) + leaf.shape).clone()
                         for leaf in one))


def sketch_query_rank(state: SketchState, k) -> torch.Tensor:
    """Value whose rank is within ``sketch_rank_bound`` of the 1-based rank
    ``k``: the first sample minimising |cum + slack//2 - k| among lanes of
    positive weight.  int32 throughout."""
    est = torch.cumsum(state.weights, -1, dtype=torch.int32) \
        + (state.slack // 2).unsqueeze(-1)
    k = torch.as_tensor(k, dtype=torch.int32, device=est.device)
    # weight-0 lanes (padding, compression duplicates) never win
    err = torch.where(state.weights > 0, (est - k.unsqueeze(-1)).abs(),
                      _INT32_MAX)
    return state.values.gather(-1, torch.argmin(err, -1, keepdim=True)) \
        .squeeze(-1)


def sketch_query_rank_batch(stacked: SketchState, ks) -> torch.Tensor:
    """(S, Q) pivots of a stacked summary for the (S, Q) target ranks."""
    ks = torch.as_tensor(ks, dtype=torch.int32, device=stacked.values.device)
    est = torch.cumsum(stacked.weights, -1, dtype=torch.int32) \
        + (stacked.slack // 2).unsqueeze(-1)
    err = torch.where(stacked.weights.unsqueeze(1) > 0,
                      (est.unsqueeze(1) - ks.unsqueeze(-1)).abs(),
                      _INT32_MAX)                           # (S, Q, s)
    return stacked.values.gather(-1, torch.argmin(err, -1))


def sketch_rank_bound(state: SketchState) -> torch.Tensor:
    """Tracked bound on ``sketch_query_rank``'s rank error: slack/2 + the
    widest gap + 2.  Caps are sized from it, so exactness never depends on
    how the stream arrived."""
    return state.slack // 2 + state.weights.max(-1).values + 2


def sketch_rank_bound_batch(stacked: SketchState) -> torch.Tensor:
    """(S,) ``sketch_rank_bound`` of each row of a stacked summary."""
    return sketch_rank_bound(stacked)


def sketch_merge_rows(stacked: SketchState) -> SketchState:
    """The K rows of one stacked summary merged into one summary through
    the ``sketch_merge_many`` tree."""
    k = stacked.values.shape[0]
    parts = [SketchState(*(leaf[i:i + 1] for leaf in stacked))
             for i in range(k)]
    return SketchState(*(leaf[0] for leaf in sketch_merge_many(parts)))


def blocked_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive float sum along the last axis in XLA's order: blocks of 16
    summed left to right, the block totals scanned the same way, each total
    added back to the block after it.  (XLA rewrites ``jnp.cumsum`` into
    this scan, so the result is ``jnp.cumsum``'s bits; ``torch.cumsum``
    adds in another order.)"""
    n = x.shape[-1]
    if n <= 16:
        cols = [x[..., 0]]
        for j in range(1, n):
            cols.append(cols[-1] + x[..., j])
        return torch.stack(cols, -1)
    m = -(-n // 16)
    blocks = torch.nn.functional.pad(x, (0, m * 16 - n)).reshape(
        *x.shape[:-1], m, 16)
    inner = blocked_cumsum(blocks)
    totals = blocked_cumsum(inner[..., 15])
    before = torch.nn.functional.pad(totals[..., :-1], (1, 0))
    return (inner + before.unsqueeze(-1)).reshape(*x.shape[:-1], m * 16)[
        ..., :n]


def sketch_query_decayed(stacked: SketchState, factors, q) -> torch.Tensor:
    """Exponential-decay weighted approximate quantile over K stacked
    sub-window summaries: every sample's weight is scaled by its row's
    factor (K,), all lanes are ranked together, and the first sample of
    positive weight whose decayed cumulative weight reaches ``q * total``
    is returned (float32 weights, summed in ``blocked_cumsum``'s order)."""
    dev = stacked.values.device
    w = stacked.weights.to(torch.float32) \
        * torch.as_tensor(factors, dtype=torch.float32, device=dev)[:, None]
    v, w = _sorted_merge(stacked.values.reshape(-1), w.reshape(-1))
    cum = blocked_cumsum(w)
    target = torch.tensor(q, dtype=torch.float32, device=dev) * cum[-1]
    hit = (cum >= target) & (w > 0)
    pos = torch.where(w > 0, torch.arange(v.shape[0], device=dev), -1)
    first = torch.argmax(hit.to(torch.uint8))
    return v[torch.where(hit.any(), first, torch.argmax(pos))]


def sketch_state_from_numpy(values, weights, n, slack,
                            device="cuda") -> SketchState:
    """A JAX ``SketchState`` given as numpy arrays (bfloat16 values as an
    ml_dtypes array or as their uint16 bits) as a ``SketchState`` on
    ``device``, bit for bit."""
    from .select import as_device_tensor
    v = np.asarray(values)
    if v.dtype == np.uint16:
        v = torch.from_numpy(v.view(np.int16).copy()).view(torch.bfloat16)
    return SketchState(values=as_device_tensor(v, device).to(device),
                       weights=as_device_tensor(
                           np.asarray(weights, np.int32), device),
                       n=as_device_tensor(np.asarray(n, np.int32), device),
                       slack=as_device_tensor(np.asarray(slack, np.int32),
                                              device))


def sketch_state_to_numpy(state: SketchState):
    """``(values, weights, n, slack)`` as numpy arrays; bfloat16 values as
    their uint16 bits (the checkpoint format's storage)."""
    v = state.values.detach().cpu()
    if v.dtype == torch.bfloat16:
        values = v.view(torch.int16).numpy().view(np.uint16)
    else:
        values = v.numpy()
    return (values, state.weights.cpu().numpy(), state.n.cpu().numpy(),
            state.slack.cpu().numpy())


# ---------------------------------------------------------------------------
# Greenwald-Khanna summary on the host (numpy; Spark QuantileSummaries)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GKSketch:
    """Greenwald–Khanna summary with Spark's head-buffer batching.

    Tuples (v_i, g_i, delta_i) maintain the invariant  g_i + delta_i <= 2*eps*n
    (Eq. 1 of the paper), guaranteeing query rank error <= eps*n.

    ``head_size`` / ``compress_threshold`` follow Spark defaults (50_000 /
    10_000).  ``adaptive_head=True`` switches to the paper's Modified Spark GK
    Sketch (§IV-E3): after each flush, B <- ceil(alpha * |S|), restoring the
    classical O(loglog) per-insert asymptotics.
    """

    eps: float
    head_size: int = 50_000
    compress_threshold: int = 10_000
    adaptive_head: bool = False
    alpha: float = 1.5

    def __post_init__(self):
        self.v = np.empty(0, dtype=np.float64)
        self.g = np.empty(0, dtype=np.int64)
        self.delta = np.empty(0, dtype=np.int64)
        self.n = 0
        self._buf: list = []
        self._B = 8 if self.adaptive_head else self.head_size
        self.flush_count = 0
        self.compress_count = 0

    # -- ingest ------------------------------------------------------------

    def insert(self, x: float) -> None:
        self._buf.append(float(x))
        if len(self._buf) >= self._B:
            self.flush()

    def insert_batch(self, xs) -> None:
        xs = np.asarray(xs, dtype=np.float64).ravel()
        pos = 0
        while pos < xs.size:
            take = self._B - len(self._buf)
            self._buf.extend(xs[pos:pos + take].tolist())
            pos += take
            if len(self._buf) >= self._B:
                self.flush()

    def flush(self) -> None:
        """Sort the head buffer and merge it into the tuple list (Spark's
        insertHeadSampled), then compress if above the threshold."""
        if not self._buf:
            return
        self.flush_count += 1
        batch = np.sort(np.asarray(self._buf, dtype=np.float64))
        self._buf = []
        new_n = self.n + batch.size
        # Inserted tuples: g=1, delta = floor(2*eps*n)-1 interior, 0 at extremes.
        ins_delta = max(0, int(math.floor(2 * self.eps * new_n)) - 1)
        pos = np.searchsorted(self.v, batch, side="right")
        total = self.v.size + batch.size
        v = np.empty(total)
        g = np.empty(total, dtype=np.int64)
        d = np.empty(total, dtype=np.int64)
        # Stable positions of the new elements in the merged array.
        new_idx = pos + np.arange(batch.size)
        mask = np.zeros(total, dtype=bool)
        mask[new_idx] = True
        v[mask] = batch
        g[mask] = 1
        d[mask] = ins_delta
        v[~mask] = self.v
        g[~mask] = self.g
        d[~mask] = self.delta
        # Extremes carry delta 0 (exact min/max).
        if total:
            d[0] = 0
            d[-1] = 0
        self.v, self.g, self.delta, self.n = v, g, d, new_n
        if self.size > self.compress_threshold or self.adaptive_head:
            self.compress()
        if self.adaptive_head:
            # Modified Spark GK (§IV-E3): B tracks the *compressed* size
            self._B = max(8, int(math.ceil(self.alpha * max(1, self.size))))

    def compress(self) -> None:
        """Greedy right-to-left merge of tuples whose combined gap+slack stays
        under 2*eps*n (Spark compressImmut). Keeps the extremes."""
        if self.size <= 2:
            return
        self.compress_count += 1
        thresh = math.floor(2 * self.eps * self.n)
        v, g, d = self.v, self.g, self.delta
        keep = np.ones(v.size, dtype=bool)
        gg = g.copy()
        nxt = v.size - 1  # index of the next *kept* tuple (tail always kept)
        for i in range(v.size - 2, 0, -1):
            if gg[i] + gg[nxt] + d[nxt] < thresh:
                gg[nxt] += gg[i]       # fold i's mass into its kept successor
                keep[i] = False
            else:
                nxt = i
        self.v, self.g, self.delta = v[keep], gg[keep], d[keep]

    # -- query -------------------------------------------------------------

    @property
    def size(self) -> int:
        return int(self.v.size)

    def rank_bounds(self) -> Tuple[np.ndarray, np.ndarray]:
        rmin = np.cumsum(self.g)
        rmax = rmin + self.delta
        return rmin, rmax

    def query_rank(self, k: int) -> float:
        """Value whose rank is within eps*n of k (k is 1-based)."""
        if self._buf:
            self.flush()
        if self.size == 0:
            raise ValueError("empty sketch")
        rmin, rmax = self.rank_bounds()
        err = np.maximum(k - rmin, rmax - k)
        return float(self.v[int(np.argmin(err))])

    def query(self, q: float) -> float:
        if self._buf:
            self.flush()
        k = min(self.n, max(1, int(math.ceil(q * self.n))))
        return self.query_rank(k)

    # -- merge (mergeable-summaries rank-bound merge) ----------------------

    def merge(self, other: "GKSketch") -> "GKSketch":
        """Merge two summaries; rank errors add (<= eps*(n_a+n_b) when both
        are eps-summaries). Rank bounds of each tuple against the other sketch
        are derived by searchsorted (Agarwal et al.'s mergeable-summaries
        merge, which is what Spark's QuantileSummaries.merge approximates).

        The sketches need not share ``eps``: the merged summary tracks
        max(eps_a, eps_b), the tightest bound the merge can still honour —
        silently keeping the smaller eps would claim a rank guarantee the
        coarser input never provided."""
        if self._buf:
            self.flush()
        if other._buf:
            other.flush()
        eps = max(self.eps, other.eps)
        if other.size == 0:
            if eps == self.eps:
                return self
            # never mutate the receiver: a widened-eps result is a new sketch
            out = GKSketch(eps, self.head_size, self.compress_threshold,
                           self.adaptive_head, self.alpha)
            out.v, out.g, out.delta, out.n = (self.v.copy(), self.g.copy(),
                                              self.delta.copy(), self.n)
            return out
        if self.size == 0:
            out = GKSketch(eps, self.head_size, self.compress_threshold,
                           self.adaptive_head, self.alpha)
            out.v, out.g, out.delta, out.n = (other.v.copy(), other.g.copy(),
                                              other.delta.copy(), other.n)
            return out

        def bounds_against(v_mine, sk: "GKSketch"):
            rmin_o, rmax_o = sk.rank_bounds()
            j = np.searchsorted(sk.v, v_mine, side="right") - 1
            lb = np.where(j >= 0, rmin_o[np.clip(j, 0, None)], 0)
            succ = j + 1
            ub = np.where(succ < sk.size,
                          rmax_o[np.clip(succ, None, sk.size - 1)] - 1, sk.n)
            return lb, ub

        rmin_a, rmax_a = self.rank_bounds()
        rmin_b, rmax_b = other.rank_bounds()
        lb_ab, ub_ab = bounds_against(self.v, other)
        lb_ba, ub_ba = bounds_against(other.v, self)
        v = np.concatenate([self.v, other.v])
        rmin = np.concatenate([rmin_a + lb_ab, rmin_b + lb_ba])
        rmax = np.concatenate([rmax_a + ub_ab, rmax_b + ub_ba])
        order = np.argsort(v, kind="stable")
        v, rmin, rmax = v[order], rmin[order], rmax[order]
        rmin = np.maximum.accumulate(rmin)
        rmax = np.maximum.accumulate(rmax)
        g = np.diff(np.concatenate([[0], rmin]))
        delta = np.maximum(0, rmax - rmin)
        out = GKSketch(eps, self.head_size, self.compress_threshold,
                       self.adaptive_head, self.alpha)
        out.v, out.g, out.delta = v, g.astype(np.int64), delta.astype(np.int64)
        out.n = self.n + other.n
        out.compress()
        return out


def merge_fold_left(sketches) -> GKSketch:
    """Spark's merge of partition sketches: a sequential pairwise foldLeft
    (Theta(P/eps log) — Eq. 7's asymptotically-worse path)."""
    out = sketches[0]
    for s in sketches[1:]:
        out = out.merge(s)
    return out


def merge_tree(sketches) -> GKSketch:
    """The paper's recommended recursive tree reduce."""
    items = list(sketches)
    while len(items) > 1:
        nxt = []
        for i in range(0, len(items) - 1, 2):
            nxt.append(items[i].merge(items[i + 1]))
        if len(items) % 2:
            nxt.append(items[-1])
        items = nxt
    return items[0]
