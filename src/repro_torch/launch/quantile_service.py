"""QuantileService: multi-tenant streaming quantile queries, in PyTorch,
and the ``StreamingCalibrator`` that serving keeps on it.

Counterpart of ``repro/launch/quantile_service.py``.  Every tensor of a service lives on its
``device`` (default ``"cuda"``; ``device="cpu"`` runs the plain versions).

Storage:

  * the **slot table**, one ``SketchState`` whose leaves carry a leading
    stream axis (capacity doubles as streams register; a name -> slot
    registry maps streams to rows; freed rows are re-initialised when they
    are handed out again);
  * the **tick ring**, one ``_TickRecord`` per ingest tick: the tick's
    sentinel-padded (S_tick, L) matrix, the slot each row fed and its valid
    lanes.  A stream's chunks are sliced out of it at query time.

An ingest tick packs its batches into one matrix (one host-to-device copy,
or one device pack), then advances every touched slot-table row in one
batched ``sketch_update_batch``: the kernels it launches do not depend on
the number of streams (``ingest_dispatches`` counts the ingest path's
device steps exactly where the JAX package counts them).

Queries:

  ``approx(q)``     O(s) from the stream's sketch row, no data pass.
  ``exact(q)``      warm GK Select: the pivot from the live sketch row, so
                    no sketch sort (``sketch_sorts`` does not tick); then one
                    count+extract per ring chunk (``fused_select`` with
                    ``fused=True``) and the resolve.  ``warm=False``
                    rebuilds the sketch from the chunks, one sort each.
  ``exact_all(qs)`` every stream at every level in one job: (G, Q) pivots
                    from the table, then per tick record one
                    ``segmented_select`` launch keyed by stream per 4096
                    pivots (``fused=True``) or the row-wise plain round.
  ``grouped``       per-group quantiles of ``ingest_grouped`` batches.
  ``windowed``      the exact quantile of a trailing window (ticks or
                    values), its pivot merged from sub-window sketch rows.
  ``approx_decayed`` an exponential-decay weighted approximate quantile.

Every exact answer is the sort oracle's, bit for bit: caps come from the
sketch's tracked rank bound, and a resolve whose realised gap exceeds the
cap is rerun wider.  Workers write into ``local_buffer()``s (``stage``, no
device work) that ``fold_many`` lands in one tick; a reader-writer lock
lets queries overlap each other and excludes them from writers.
``snapshot``/``from_snapshot`` round-trip the whole state (format 2; format
1 reads as an unwindowed service), in the JAX package's layout.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import os
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core import engine, local_ops
from ..core.grouped import (grouped_sketch_samples, query_grouped_sketch,
                            segmented_sketch_local)
from ..core.select import as_device_tensor
from ..core.sketch import (SketchState, record_sketch_sort, sketch_budget,
                           sketch_init, sketch_init_stack,
                           sketch_merge_many, sketch_merge_rows,
                           sketch_query_decayed, sketch_query_rank,
                           sketch_query_rank_batch, sketch_rank_bound,
                           sketch_update, sketch_update_batch)
from ..kernels import ops as kernel_ops
from ..kernels.ref import _capped_band, _sentinels


def _round_up(x: int, multiple: int) -> int:
    return -(-x // multiple) * multiple


# --- ingest dispatch counter ------------------------------------------------
# One ingest tick takes a constant number of device steps whatever the
# number of streams it touches; every step of the ingest path ticks this.
# Lock-guarded, so that threaded ingest drops no tick.
_INGEST_DISPATCHES = {"count": 0}
_INGEST_DISPATCHES_LOCK = threading.Lock()


def reset_ingest_dispatches() -> None:
    with _INGEST_DISPATCHES_LOCK:
        _INGEST_DISPATCHES["count"] = 0


def ingest_dispatches() -> int:
    with _INGEST_DISPATCHES_LOCK:
        return _INGEST_DISPATCHES["count"]


def record_ingest_dispatch(n: int = 1) -> None:
    with _INGEST_DISPATCHES_LOCK:
        _INGEST_DISPATCHES["count"] += n


# --- reader-writer lock -----------------------------------------------------


class RWLock:
    """Shared/exclusive lock with a reentrant writer.

    Queries (readers) overlap each other and wait only while a writer
    holds the lock.  The writer is reentrant (``fold_many`` re-enters
    ``ingest_batch``) and may take the read side.  Read-to-write upgrades
    are not supported; no query path mutates."""

    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0
        self._writer: Optional[int] = None   # owning thread ident
        self._depth = 0

    @contextlib.contextmanager
    def read(self):
        me = threading.get_ident()
        if self._writer == me:        # writer re-entering as a reader
            yield
            return
        with self._cond:
            while self._writer is not None:
                self._cond.wait()
            self._readers += 1
        try:
            yield
        finally:
            with self._cond:
                self._readers -= 1
                if self._readers == 0:
                    self._cond.notify_all()

    @contextlib.contextmanager
    def write(self):
        me = threading.get_ident()
        with self._cond:
            if self._writer == me:
                self._depth += 1
            else:
                while self._writer is not None or self._readers > 0:
                    self._cond.wait()
                self._writer = me
                self._depth = 1
        try:
            yield
        finally:
            with self._cond:
                self._depth -= 1
                if self._depth == 0:
                    self._writer = None
                    self._cond.notify_all()


def _locked(kind: str):
    """Method decorator: run under the service's read ("r") or write ("w")
    lock."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(self, *args, **kwargs):
            ctx = self._rw.read() if kind == "r" else self._rw.write()
            with ctx:
                return fn(self, *args, **kwargs)
        return wrapper
    return deco


def _query(fn):
    """Query decorator: commit any staged host batches first (a write),
    then run under the read lock.  ``commit=False`` skips the commit: the
    query then reads committed state only and never mutates."""
    @functools.wraps(fn)
    def wrapper(self, *args, commit: bool = True, **kwargs):
        if commit and self._staged:
            self.commit_staged()
        with self._rw.read():
            return fn(self, *args, **kwargs)
    return wrapper


# --- device steps -----------------------------------------------------------


def _gather_rows(stacked: SketchState, slots: torch.Tensor) -> SketchState:
    return SketchState(*(leaf[slots] for leaf in stacked))


def _scatter_rows(stacked: SketchState, slots: torch.Tensor,
                  rows: SketchState) -> SketchState:
    # out of place, as JAX's .at[].set: views handed out earlier keep their
    # values
    return SketchState(*(leaf.index_put((slots,), r)
                         for leaf, r in zip(stacked, rows)))


def _update_rows(stacked: SketchState, slots, matrix, n_valid) -> SketchState:
    """Advance every touched slot in one batched update: gather the rows,
    run ``sketch_update_batch``, scatter the rows back."""
    upd = sketch_update_batch(_gather_rows(stacked, slots), matrix, n_valid)
    return _scatter_rows(stacked, slots, upd)


def _update_rows_doubled(stacked: SketchState, slots2, matrix,
                         n_valid) -> SketchState:
    """Windowed ingest: advance both the all-history row and the current
    sub-window row of every touched stream in one batched update.  Row i of
    the (S, L) matrix feeds ``slots2[i]`` and ``slots2[S + i]``.  A row with
    no valid lanes points both at its main slot: the update leaves that row
    bit-unchanged, so the two writes to the slot carry the same values, and
    which duplicate the scatter keeps (unspecified on CUDA) does not
    matter."""
    upd = sketch_update_batch(_gather_rows(stacked, slots2),
                              torch.cat([matrix, matrix]),
                              torch.cat([n_valid, n_valid]))
    return _scatter_rows(stacked, slots2, upd)


def _fold_rows(mine: SketchState, my_slots, tables, idxs) -> SketchState:
    """Fold the slot rows of K worker tables into ours in one tree merge:
    each table gets an empty row appended, which the missing names (index
    -1) select."""
    parts = [_gather_rows(mine, my_slots)]
    for table, idx in zip(tables, idxs):
        empty = sketch_init_stack(1, table.values.shape[1], table.values.dtype,
                                  table.values.device)
        ext = SketchState(*(torch.cat([a, e]) for a, e in zip(table, empty)))
        idx = torch.where(idx < 0, table.values.shape[0], idx)
        parts.append(_gather_rows(ext, idx))
    return _scatter_rows(mine, my_slots, sketch_merge_many(parts))


def _reset_rows(stacked: SketchState, slots) -> SketchState:
    """Re-initialise recycled slots (rows freed by ``drop_stream``)."""
    fresh = sketch_init_stack(slots.shape[0], stacked.values.shape[1],
                              stacked.values.dtype, stacked.values.device)
    return _scatter_rows(stacked, slots, fresh)


# Transforms an ingest may apply before padding.  "abs_f32" is |x| in f32.
# stage() applies them to host tensors: |x| clears the sign bit and the
# cast to f32 rounds as on the device, so staged answers are the same.
_TRANSFORMS = {
    "abs_f32": lambda a: a.to(torch.float32).abs(),
}


def _host_tensor(b) -> torch.Tensor:
    """A batch as a flat CPU tensor (numpy incl. ml_dtypes bfloat16,
    sequences, tensors)."""
    if isinstance(b, torch.Tensor):
        return b.detach().reshape(-1).cpu()
    return as_device_tensor(np.asarray(b), "cpu").reshape(-1)


def _host_matrix(batches, lengths, length: int,
                 dtype: torch.dtype) -> torch.Tensor:
    """Flat host batches (numpy arrays or CPU tensors) as one (S, length)
    CPU matrix of ``dtype``, padded with its high sentinel.  Filled in
    numpy where the dtype and every batch have a numpy type (a row copy
    there costs a fraction of torch's), else in torch (bfloat16)."""
    _, hi = _sentinels(dtype)
    np_dtype = _NUMPY_DTYPES.get(dtype)
    if np_dtype is not None and not any(_is_bf16(b) for b in batches):
        host = np.full((len(batches), length), hi.item(), np_dtype)
        for i, b in enumerate(batches):
            host[i, :lengths[i]] = (b.numpy() if isinstance(b, torch.Tensor)
                                    else b)
        return torch.from_numpy(host)
    host = hi.expand(len(batches), length).clone()
    for i, b in enumerate(batches):
        host[i, :lengths[i]] = _host_tensor(b)
    return host


def _is_bf16(b) -> bool:
    if isinstance(b, torch.Tensor):
        return b.dtype == torch.bfloat16
    return b.dtype.name == "bfloat16"


_NUMPY_DTYPES = {torch.float32: np.float32, torch.float64: np.float64,
                 torch.float16: np.float16, torch.int32: np.int32,
                 torch.int64: np.int64}


def _dtype_of(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype or a dtype name ("float32", ...)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = getattr(dtype, "name", dtype)
    out = getattr(torch, str(name), None)
    if not isinstance(out, torch.dtype):
        raise TypeError(f"unsupported dtype {dtype!r}")
    return out


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _row_count_extract(data: torch.Tensor, row_pivots: torch.Tensor,
                       n_valid: torch.Tensor, cap: int):
    """Row-aligned count+extract of a tick record: row i of the (S, L)
    matrix meets only its own Q pivots ``row_pivots[i]``; lanes past
    ``n_valid[i]`` are padding.  ``(counts (S, Q, 3), below (S, Q, cap),
    above (S, Q, cap))`` with the bands in the total order of
    ``lax.top_k``."""
    lane = torch.arange(data.shape[1], device=data.device)
    valid = (lane < n_valid.unsqueeze(-1)).unsqueeze(1)          # (S, 1, L)
    x = data.unsqueeze(1)
    p = row_pivots.unsqueeze(-1)                                 # (S, Q, 1)
    is_lt = valid & (x < p)
    is_gt = valid & (x > p)
    counts = torch.stack([is_lt.sum(-1, dtype=torch.int32),
                          (valid & (x == p)).sum(-1, dtype=torch.int32),
                          is_gt.sum(-1, dtype=torch.int32)], dim=-1)
    return (counts, _capped_band(x, is_lt, cap, True),
            _capped_band(x, is_gt, cap, False))


@dataclasses.dataclass(frozen=True)
class Window:
    """Trailing window for ``QuantileService.windowed``: exactly one of
    ``ticks`` (the last N ingest ticks) or ``values`` (the stream's last N
    values).  A bare ``int`` passed as ``window=`` means ticks."""
    ticks: Optional[int] = None
    values: Optional[int] = None

    def __post_init__(self):
        if (self.ticks is None) == (self.values is None):
            raise ValueError("specify exactly one of Window(ticks=...) or "
                             "Window(values=...)")
        span = self.ticks if self.ticks is not None else self.values
        if int(span) < 1:
            raise ValueError(f"window must be positive, got {span}")


def _as_window(window) -> Window:
    if isinstance(window, Window):
        return window
    return Window(ticks=int(window))


@dataclasses.dataclass
class _SubWindow:
    """One live sub-window of a stream: its slot-table row, its index on the
    tick clock (ticks [index*sub_ticks, (index+1)*sub_ticks - 1]) and the
    values folded into it."""
    slot: int
    index: int
    n: int


@dataclasses.dataclass
class _TickRecord:
    """One ingest tick: the sentinel-padded (S_tick, L) matrix, per row the
    slot it fed (-1 once that stream is dropped) and its valid lanes, and
    the tick's stamp on the logical clock."""
    data: torch.Tensor        # (S_tick, L) on the service's device
    slots: np.ndarray         # (S_tick,) int32 slot ids, -1 = dropped
    n_valid: np.ndarray       # (S_tick,) int32 valid lanes per row
    tick: int = 0


@dataclasses.dataclass
class _StreamView:
    """Read-only view of one stream: its sketch row, its chunks and count."""
    state: SketchState
    chunks: List[torch.Tensor]
    n: int


@dataclasses.dataclass
class _GroupedStream:
    chunks: List[torch.Tensor]        # values, flat per ingest batch
    key_chunks: List[torch.Tensor]    # int32 group ids, aligned with chunks
    n: int


class QuantileService:
    """Slot table of stacked stream sketches + a tick ring of raw batches,
    on one device."""

    def __init__(self, *, eps: float = 0.01, budget: Optional[int] = None,
                 dtype=torch.float32, fused: bool = False,
                 check_nans: bool = True, window_ticks: Optional[int] = None,
                 window_subs: int = 8, device="cuda"):
        """``exact``/``exact_all``/``grouped``/``windowed`` answers are
        bit-identical to a sort of what was ingested, whatever the flags:
        they steer data movement only.

        ``fused=True`` runs each query's count+extract through the Hopper
        kernels on a CUDA device (``fused_select`` per ring chunk,
        ``segmented_select`` per tick record); on the CPU both routes run
        plain PyTorch.  The JAX service's ``backend`` argument picks among
        its kernel implementations and has no counterpart here: the device
        alone decides (``kernels.dispatch``).

        ``window_ticks=W`` turns on windowed retention: ring records and
        sub-window rows older than W ticks are retired, and all-history
        ``exact``/``exact_all`` raise once a stream's history slides out;
        ``window_subs`` sub-windows split the window.

        NaN policy: reject at ingest, one host sync per tick;
        ``check_nans=False`` hands that contract to the caller.

        ``device`` holds every tensor of the service: host batches go
        there, and a tensor on another device raises ``ValueError``.
        ``"cuda"`` without a card raises."""
        if not 0.0 < eps < 1.0:
            raise ValueError(f"eps must be in (0,1), got {eps}")
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("CUDA is not available; pass "
                                   "device='cpu' to run on the CPU")
            if self.device.index is None:       # tensors report cuda:<i>
                self.device = torch.device("cuda",
                                           torch.cuda.current_device())
        self.eps = eps
        self.budget = int(budget) if budget else sketch_budget(eps)
        self.dtype = _dtype_of(dtype)
        self.fused = fused
        self.check_nans = check_nans
        # --- windowed retention --------------------------------------------
        if window_ticks is not None and int(window_ticks) < 1:
            raise ValueError(f"window_ticks must be >= 1, got {window_ticks}")
        if int(window_subs) < 1:
            raise ValueError(f"window_subs must be >= 1, got {window_subs}")
        self.window_ticks = int(window_ticks) if window_ticks else None
        self.window_subs = int(window_subs)
        self._sub_ticks = (-(-self.window_ticks // self.window_subs)
                           if self.window_ticks else 0)
        self._tick = 0                               # logical clock
        self._subs: Dict[int, List[_SubWindow]] = {}  # main slot -> subs
        self._retained: List[int] = []               # per-slot live values
        self._rw = RWLock()
        # --- slot table ----------------------------------------------------
        self._stacked: Optional[SketchState] = None   # leaves (capacity, ...)
        self._names: Dict[str, int] = {}              # name -> slot
        self._free: List[int] = []                    # unassigned slots
        self._dirty: set = set()                      # freed, needs re-init
        self._counts: List[int] = []                  # per-slot value count
        self._capacity: int = 0
        self._ring: List[_TickRecord] = []
        self._grouped: Dict[str, _GroupedStream] = {}
        # --- staged host batches (the worker-thread write path) ------------
        self._staged: Dict[str, List[torch.Tensor]] = {}
        self._staged_n: int = 0

    def _on_device(self, x) -> torch.Tensor:
        """A tensor on the service's device as it is, host data moved
        there; a tensor elsewhere raises."""
        if isinstance(x, torch.Tensor):
            if x.device != self.device:
                raise ValueError(f"tensor on device {x.device}, service on "
                                 f"{self.device}: move it explicitly")
            return x
        return as_device_tensor(np.asarray(x), "cpu").to(self.device)

    def _slot_index(self, slots) -> torch.Tensor:
        return torch.as_tensor(np.asarray(slots, np.int64), device=self.device)

    # -- slot table ----------------------------------------------------------

    def _grow(self, min_capacity: int) -> None:
        """Capacity-doubling growth of the stacked table."""
        new_cap = max(4, self._capacity)
        while new_cap < min_capacity:
            new_cap *= 2
        if new_cap == self._capacity:
            return
        add = new_cap - self._capacity
        fresh = sketch_init_stack(add, self.budget, self.dtype, self.device)
        if self._stacked is None:
            self._stacked = fresh
        else:
            self._stacked = SketchState(*(torch.cat([a, f]) for a, f in
                                          zip(self._stacked, fresh)))
        record_ingest_dispatch()
        self._free.extend(range(self._capacity, new_cap))
        self._counts.extend([0] * add)
        self._retained.extend([0] * add)
        self._capacity = new_cap

    def _alloc_slots(self, count: int) -> List[int]:
        """Take ``count`` slots off the free list (growing the table as
        needed); recycled rows are re-initialised in one batched reset."""
        if len(self._free) < count:
            self._grow(self._capacity + (count - len(self._free)))
        out, recycled = [], []
        for _ in range(count):
            slot = self._free.pop()
            if slot in self._dirty:
                recycled.append(slot)
                self._dirty.discard(slot)
            self._counts[slot] = 0
            self._retained[slot] = 0
            out.append(slot)
        if recycled:
            self._stacked = _reset_rows(self._stacked,
                                        self._slot_index(recycled))
            record_ingest_dispatch()
        return out

    def _free_slot(self, slot: int) -> None:
        """Return one slot to the free list (its row is re-initialised when
        it is handed out again)."""
        self._free.append(slot)
        self._dirty.add(slot)
        self._counts[slot] = 0
        self._retained[slot] = 0

    def _ensure_slots(self, names: Sequence[str]) -> np.ndarray:
        """Register unknown names and return the slot of each name."""
        missing = [n for n in names if n not in self._names]
        if missing:
            for n, slot in zip(missing, self._alloc_slots(len(missing))):
                self._names[n] = slot
        return np.asarray([self._names[n] for n in names], dtype=np.int32)

    def _row_state(self, slot: int) -> SketchState:
        return SketchState(*(leaf[slot] for leaf in self._stacked))

    def _chunks_for(self, slot: int) -> List[torch.Tensor]:
        """This slot's chunks, sliced out of the tick ring."""
        return [rec.data[i, :nv] for rec, i, nv in self._stream_rows(slot)]

    def _stream_rows(self, slot: int):
        """This slot's non-empty ring rows as (record, row, n_valid), oldest
        tick first."""
        out = []
        for rec in self._ring:
            for i in np.nonzero(rec.slots == slot)[0]:
                nv = int(rec.n_valid[i])
                if nv:
                    out.append((rec, int(i), nv))
        return out

    # -- windowed retention internals ----------------------------------------

    def _rotate_subs(self, slots: np.ndarray, n_valid: np.ndarray,
                     tick: int) -> np.ndarray:
        """Per touched stream: retire sub-windows past the horizon, open a
        fresh sub-window row when the tick crossed a ``sub_ticks`` boundary,
        and count this tick's values.  Returns the sub-window slot of each
        tick row (its main slot for a row with no valid lanes)."""
        idx = tick // self._sub_ticks
        horizon = tick + 1 - self.window_ticks   # oldest retained tick
        sub_slots = np.empty(len(slots), np.int32)
        need_new = []
        for i, (slot, nv) in enumerate(zip(slots, n_valid)):
            if not nv:
                sub_slots[i] = slot
                continue
            subs = self._subs.setdefault(int(slot), [])
            while subs and (subs[0].index + 1) * self._sub_ticks <= horizon:
                self._free_slot(subs.pop(0).slot)
            if subs and subs[-1].index == idx:
                sub_slots[i] = subs[-1].slot
            else:
                need_new.append(i)
        if need_new:
            for i, slot in zip(need_new, self._alloc_slots(len(need_new))):
                self._subs[int(slots[i])].append(
                    _SubWindow(slot=slot, index=idx, n=0))
                sub_slots[i] = slot
        for slot, nv in zip(slots, n_valid):
            if nv:
                self._subs[int(slot)][-1].n += int(nv)
        return sub_slots

    def _retire_ring(self) -> None:
        """Drop ring records past the retention horizon, taking their values
        off the per-slot retained counts."""
        horizon = self._tick - self.window_ticks
        if horizon <= 0:
            return
        keep = []
        for rec in self._ring:
            if rec.tick >= horizon:
                keep.append(rec)
                continue
            for s, nv in zip(rec.slots, rec.n_valid):
                if s >= 0:
                    self._retained[int(s)] -= int(nv)
        self._ring = keep

    # -- stream lifecycle ---------------------------------------------------

    @_locked("w")
    def stream(self, name: str) -> _StreamView:
        """Get-or-create accessor: registers ``name`` if unknown and returns
        a read-only view of its row and chunks."""
        self._ensure_slots([name])
        slot = self._names[name]
        return _StreamView(state=self._row_state(slot),
                           chunks=self._chunks_for(slot),
                           n=self._counts[slot])

    @_locked("r")
    def streams(self):
        return sorted(self._names)

    @_locked("w")
    def drop_stream(self, name: str) -> None:
        """Forget one stream: its slot and sub-window slots return to the
        free list and its ring rows are marked -1, so that a later tenant of
        the slot never sees them."""
        slot = self._names.pop(name, None)
        if slot is not None:
            for sub in self._subs.pop(slot, []):
                self._free_slot(sub.slot)
            self._free_slot(slot)
            for rec in self._ring:
                rec.slots[rec.slots == slot] = -1
            self._ring = [r for r in self._ring if (r.slots >= 0).any()]
        self._grouped.pop(name, None)

    @_locked("r")
    def stream_count(self, name: str) -> int:
        """Values of ``name`` (0 for unknown names; staged values are not
        counted)."""
        slot = self._names.get(name)
        return self._counts[slot] if slot is not None else 0

    @_locked("r")
    def grouped_stream_count(self, name: str) -> int:
        st = self._grouped.get(name)
        return st.n if st else 0

    @_locked("r")
    def rank_bound(self, name: str) -> int:
        """The live sketch's tracked rank-error bound (unknown names raise
        ``KeyError``)."""
        slot = self._names.get(name)
        if slot is None:
            raise KeyError(f"unknown stream {name!r}")
        return int(sketch_rank_bound(self._row_state(slot)))

    # -- ingest -------------------------------------------------------------

    def ingest(self, name: str, batch) -> None:
        """Fold one batch into one stream: S=1 case of ``ingest_batch``."""
        self.ingest_batch([name], [batch])

    @_locked("w")
    def ingest_batch(self, names: Sequence[str], batches, *,
                     transform: Optional[str] = None) -> None:
        """Fold one batch per named stream as one tick:

          1. pack the batches into one sentinel-padded (S, L) matrix: filled
             on the host and copied once for host data, packed in one
             ``torch.cat`` and one scatter for tensors;
          2. one batched ``sketch_update_batch`` over the touched rows of
             the slot table (one sort of the tick; ticks ``sketch_sorts``
             once);
          3. append one ``_TickRecord`` to the ring.

        Host batches (numpy, ml_dtypes bfloat16, sequences) go to the
        service's device; tensors must already be there.  ``transform``
        names a pre-transform (``"abs_f32"``).  NaN policy: reject.  A tick
        whose batches are all empty is a no-op; a mixed tick registers its
        empty rows' streams."""
        self._ingest(list(names), list(batches), transform, nan_checked=False,
                     staged=False)

    def _ingest(self, names, batches, transform, *, nan_checked: bool,
                staged: bool) -> None:
        if len(names) != len(batches):
            raise ValueError(f"names/batches length mismatch: "
                             f"{len(names)} vs {len(batches)}")
        if len(set(names)) != len(names):
            raise ValueError("duplicate stream names in one ingest tick")
        if not names:
            return
        if transform is not None and transform not in _TRANSFORMS:
            raise ValueError(f"unknown transform {transform!r}; "
                             f"have {sorted(_TRANSFORMS)}")
        device_in = not staged and (transform is not None or any(
            isinstance(b, torch.Tensor) for b in batches))
        if device_in:
            batches = [self._on_device(b).reshape(-1) for b in batches]
        else:
            batches = [b.reshape(-1) if isinstance(b, torch.Tensor)
                       else np.asarray(b).reshape(-1) for b in batches]
        lengths = [int(np.prod(b.shape)) for b in batches]
        length = max(lengths)
        if length == 0:
            return                      # all-empty tick: complete no-op

        slots = self._ensure_slots(names)
        if device_in:
            matrix = self._pack(batches, lengths, length, transform)
        else:
            matrix = _host_matrix(batches, lengths, length,
                                  self.dtype).to(self.device)
        record_ingest_dispatch()        # the one pack or host->device copy
        n_valid = np.asarray(lengths, dtype=np.int32)

        if self.check_nans and not nan_checked:
            local_ops.reject_nans(matrix, "QuantileService.ingest")

        tick = self._tick
        record_sketch_sort()            # sketch_update_batch sorts the tick
        record_ingest_dispatch()        # the one batched update
        nv = torch.as_tensor(n_valid, device=self.device)
        if self.window_ticks is not None:
            sub_slots = self._rotate_subs(slots, n_valid, tick)
            self._stacked = _update_rows_doubled(
                self._stacked, self._slot_index(np.concatenate([slots,
                                                                sub_slots])),
                matrix, nv)
        else:
            self._stacked = _update_rows(self._stacked,
                                         self._slot_index(slots), matrix, nv)
        for slot, n in zip(slots, n_valid):
            self._counts[int(slot)] += int(n)
            self._retained[int(slot)] += int(n)
        self._ring.append(_TickRecord(data=matrix, slots=slots.copy(),
                                      n_valid=n_valid, tick=tick))
        self._tick = tick + 1
        if self.window_ticks is not None:
            self._retire_ring()

    def _pack(self, batches, lengths, length: int,
              transform: Optional[str]) -> torch.Tensor:
        """Flat device batches as one sentinel-padded (S, length) matrix:
        one concatenation, the transform and cast once, one scatter (no
        step per stream when the batches share a dtype)."""
        tf = _TRANSFORMS[transform] if transform else None
        if len({b.dtype for b in batches}) > 1:
            batches = [(tf(b) if tf else b).to(self.dtype) for b in batches]
            tf = None
        # a copy either way: the ring must not alias the caller's tensor
        flat = torch.cat(batches) if len(batches) > 1 else batches[0].clone()
        if tf is not None:
            flat = tf(flat)
        flat = flat.to(self.dtype)
        S = len(batches)
        if all(n == length for n in lengths):
            return flat.reshape(S, length)
        _, hi = _sentinels(self.dtype, self.device)
        matrix = hi.expand(S, length).clone()
        lens = torch.as_tensor(lengths, device=self.device)
        row = torch.repeat_interleave(torch.arange(S, device=self.device),
                                      lens, output_size=flat.numel())
        start = torch.cumsum(lens, 0) - lens
        lane = torch.arange(flat.numel(), device=self.device) - start[row]
        matrix[row, lane] = flat
        return matrix

    @_locked("w")
    def ingest_grouped(self, name: str, values, keys) -> None:
        """Buffer one (values, int32 group keys) batch for per-group
        queries; keys outside [0, G) belong to no group.  NaN policy:
        reject."""
        values = self._on_device(values).reshape(-1).to(self.dtype).clone()
        keys = self._on_device(keys).reshape(-1).to(torch.int32).clone()
        if values.shape != keys.shape:
            raise ValueError(f"values/keys length mismatch: "
                             f"{tuple(values.shape)} vs {tuple(keys.shape)}")
        if self.check_nans:
            local_ops.reject_nans(values, "QuantileService.ingest_grouped")
        if values.numel() == 0:
            return
        st = self._grouped.setdefault(name, _GroupedStream([], [], 0))
        st.chunks.append(values)
        st.key_chunks.append(keys)
        st.n += int(values.numel())

    # -- staging (the worker-thread write path) ------------------------------

    @_locked("w")
    def stage(self, name: str, batch, *,
              transform: Optional[str] = None) -> None:
        """Append one batch on the host, with no device work;
        ``commit_staged`` (or ``fold_many``) later lands everything staged
        as one tick.  ``transform`` applies its host mirror now.  NaN policy
        is enforced here for every float batch (the JAX service defers
        ml_dtypes batches to the commit), so the error surfaces in the
        thread that staged it."""
        if transform is not None:
            if transform not in _TRANSFORMS:
                raise ValueError(f"unknown transform {transform!r}; "
                                 f"have {sorted(_TRANSFORMS)}")
            arr = _TRANSFORMS[transform](_host_tensor(batch))
        else:
            arr = _host_tensor(batch)
        if (self.check_nans and self.dtype.is_floating_point
                and arr.is_floating_point() and bool(torch.isnan(arr).any())):
            raise ValueError(f"QuantileService.stage: NaN in input for "
                             f"stream {name!r} (NaN policy: reject)")
        self._staged.setdefault(name, []).append(arr)
        self._staged_n += int(arr.numel())

    @property
    def staged_count(self) -> int:
        """Values staged on the host and not yet committed."""
        return self._staged_n

    def _land_staged(self, staged: Dict[str, List[torch.Tensor]]) -> None:
        names = sorted(staged)
        batches = [staged[n][0] if len(staged[n]) == 1
                   else torch.cat(staged[n]) for n in names]
        self._ingest(names, batches, None, nan_checked=True, staged=True)

    @_locked("w")
    def commit_staged(self) -> None:
        """Land everything staged as one ingest tick (no-op when nothing
        is staged)."""
        if not self._staged:
            return
        staged, self._staged = self._staged, {}
        self._staged_n = 0
        self._land_staged(staged)

    # -- fold (worker buffers) -----------------------------------------------

    def local_buffer(self) -> "QuantileService":
        """A private worker-side buffer with this service's sketch
        configuration and device (no window: a buffer has no tick
        clock)."""
        return QuantileService(eps=self.eps, budget=self.budget,
                               dtype=self.dtype, fused=self.fused,
                               check_nans=self.check_nans, device=self.device)

    def _validate_fold(self, other: "QuantileService") -> None:
        """A buffer folds in only if its whole configuration matches."""
        mismatched = [
            f"{field}: {theirs!r} vs {ours!r}"
            for field, theirs, ours in [
                ("budget", other.budget, self.budget),
                ("dtype", other.dtype, self.dtype),
                ("eps", other.eps, self.eps),
                ("fused", bool(other.fused), bool(self.fused)),
                ("device", other.device, self.device),
            ] if theirs != ours]
        if mismatched:
            raise ValueError("cannot fold: config mismatch "
                             "(" + "; ".join(mismatched) + ")")
        if other.window_ticks is not None:
            raise ValueError(
                "cannot fold a windowed buffer: its tick clock is private "
                "and meaningless on the target — worker buffers must be "
                "plain (local_buffer() makes them so)")

    def fold(self, other: "QuantileService") -> None:
        """Fold one worker buffer into this service (``fold_many`` of
        one)."""
        self.fold_many([other])

    @_locked("w")
    def fold_many(self, others: Sequence["QuantileService"]) -> None:
        """Fold several quiescent worker buffers at once: their staged host
        batches land as one ingest tick, and their materialised slot rows
        in one tree merge.  Exact answers do not depend on fold order."""
        others = [o for o in others if o is not self]
        for other in others:
            self._validate_fold(other)

        staged: Dict[str, List[torch.Tensor]] = {}
        for other in others:
            if not other._staged:
                continue
            for name, arrs in other._staged.items():
                staged.setdefault(name, []).extend(arrs)
            other._staged = {}
            other._staged_n = 0
        if staged:
            self._land_staged(staged)

        tabled = [o for o in others if o._names and o._stacked is not None]
        if tabled and self.window_ticks is not None:
            raise ValueError(
                "cannot fold materialized worker tables into a windowed "
                "service — stage() into the buffer (or ingest through the "
                "shared service) so values land with a tick")
        if tabled:
            union = sorted({n for o in tabled for n in o._names})
            my_slots = self._ensure_slots(union)
            idxs = [self._slot_index([o._names.get(n, -1) for n in union])
                    for o in tabled]
            self._stacked = _fold_rows(self._stacked,
                                       self._slot_index(my_slots),
                                       [o._stacked for o in tabled], idxs)
            record_ingest_dispatch()
            slot_of = {n: int(m) for n, m in zip(union, my_slots)}
            adopted = False
            for o in tabled:
                remap = {int(t): slot_of[n] for n, t in o._names.items()}
                for t, m in remap.items():
                    self._counts[m] += o._counts[t]
                    self._retained[m] += o._counts[t]
                for rec in o._ring:
                    new_slots = np.asarray(
                        [remap.get(int(s), -1) for s in rec.slots],
                        dtype=np.int32)
                    if (new_slots >= 0).any():
                        # adopted records land at the current tick
                        self._ring.append(_TickRecord(
                            data=rec.data, slots=new_slots,
                            n_valid=rec.n_valid.copy(), tick=self._tick))
                        adopted = True
            if adopted:
                self._tick += 1

        for other in others:
            for name, gs in other._grouped.items():
                mine = self._grouped.setdefault(name,
                                                _GroupedStream([], [], 0))
                mine.chunks.extend(gs.chunks)
                mine.key_chunks.extend(gs.key_chunks)
                mine.n += gs.n

    # -- queries ------------------------------------------------------------

    def _require(self, name: str) -> int:
        slot = self._names.get(name)
        if slot is None or self._counts[slot] == 0:
            raise ValueError(f"stream {name!r} is empty")
        return slot

    def _require_full_history(self, name: str, slot: int) -> None:
        """All-history exact queries need every value resident."""
        if self._retained[slot] < self._counts[slot]:
            raise ValueError(
                f"stream {name!r}: {self._counts[slot] - self._retained[slot]}"
                f" of {self._counts[slot]} values have been retired past the "
                f"retention horizon ({self.window_ticks} ticks) — "
                f"all-history exact queries are unavailable on a windowed "
                f"service once history slides out; use windowed() or "
                f"approx()")

    @_query
    def approx(self, name: str, q: float):
        """Approximate q-quantile from the sketch row alone: O(s), no data
        pass; rank error <= ``rank_bound(name)``."""
        slot = self._require(name)
        k = local_ops.target_rank(self._counts[slot], q)
        return sketch_query_rank(self._row_state(slot), k)

    @_query
    def exact(self, name: str, q: float, *, warm: bool = True):
        """Exact q-quantile of everything ingested, as a 0-d tensor.

        ``warm=True``: the pivot from the live sketch row, no sketch sort.
        ``warm=False``: the sketch rebuilt from the chunks (one sort each),
        as a stateless job would.  Both give the same bits."""
        slot = self._require(name)
        self._require_full_history(name, slot)
        n = self._counts[slot]
        k = local_ops.target_rank(n, q)
        chunks = self._chunks_for(slot)
        if warm:
            state = self._row_state(slot)
            pivot = sketch_query_rank(state, k)
            bound = int(sketch_rank_bound(state))
        else:
            pivot, bound = self._cold_pivot(chunks, k)
        cap = min(n, _round_up(bound + 2, 128))
        return self._count_extract_resolve(chunks, n, k, pivot, cap)

    @_query
    def windowed(self, name: str, q: float, *, window):
        """Exact q-quantile of the values inside a trailing window
        (``Window(ticks=N)``, ``Window(values=N)`` or an int of ticks).  On
        a windowed service the pivot comes from merging the covering
        sub-window rows (no sketch sort) and the cap adds half the cover's
        overcount; otherwise the pivot is rebuilt from the window's slices.
        Raises when the window reaches past the retention horizon or holds
        no value."""
        win = _as_window(window)
        slot = self._require(name)
        slices, n_w, start = self._window_slices(name, slot, win)
        if n_w == 0:
            raise ValueError(f"stream {name!r} has no values in the window")
        k = local_ops.target_rank(n_w, q)
        pivot, bound = self._window_pivot(slot, k, n_w, start, slices)
        cap = min(n_w, _round_up(bound + 2, 128))
        return self._count_extract_resolve(slices, n_w, k, pivot, cap)

    @_locked("r")
    def window_count(self, name: str, *, window) -> int:
        """Values of ``name`` inside the trailing window (0 for unknown
        streams; a values window reports ``min(N, retained)``)."""
        win = _as_window(window)
        slot = self._names.get(name)
        if slot is None:
            return 0
        if win.values is not None:
            return min(int(win.values), self._retained[slot])
        start = self._tick - int(win.ticks)
        return sum(nv for rec, _, nv in self._stream_rows(slot)
                   if rec.tick >= start)

    @_query
    def approx_decayed(self, name: str, q: float, *, halflife: float):
        """Exponential-decay weighted approximate q-quantile from the
        retained sub-window rows: a value ``halflife`` ticks old counts half
        as much as one of this tick (age from the tick its sub-window
        opened).  Needs a windowed service."""
        if self.window_ticks is None:
            raise ValueError("approx_decayed requires a windowed service "
                             "(construct with window_ticks=...)")
        if not halflife > 0:
            raise ValueError(f"halflife must be positive, got {halflife}")
        slot = self._require(name)
        subs = [s for s in self._subs.get(slot, []) if s.n > 0]
        if not subs:
            raise ValueError(f"stream {name!r} has no retained sub-windows")
        now = self._tick - 1
        ages = np.asarray(
            [max(0, now - s.index * self._sub_ticks) for s in subs],
            np.float32)
        factors = torch.from_numpy(np.exp2(-ages / halflife)).to(self.device)
        rows = _gather_rows(self._stacked,
                            self._slot_index([s.slot for s in subs]))
        return sketch_query_decayed(rows, factors, q)

    @_locked("r")
    def memory_stats(self) -> Dict[str, int]:
        """Resident-footprint counters (host bookkeeping, no device work):
        ``resident_values`` is ring lanes + table rows x budget."""
        ring_lanes = sum(rec.data.numel() for rec in self._ring)
        ring_values = sum(int(rec.n_valid.sum()) for rec in self._ring)
        return {
            "ring_records": len(self._ring),
            "ring_values": ring_values,
            "ring_lanes": ring_lanes,
            "table_rows": self._capacity,
            "live_rows": self._capacity - len(self._free),
            "budget": self.budget,
            "resident_values": ring_lanes + self._capacity * self.budget,
        }

    @_query
    def exact_all(self, qs):
        """Exact quantiles at every level of ``qs`` for every non-empty
        stream in one job: (G, Q) pivots from the slot table (no sketch
        sort), then per tick record ``segmented_select`` keyed by stream
        (``fused=True``; one launch per 4096 pivots) or the row-wise round.
        Returns ``{name: (Q,) values}``."""
        qs = tuple(float(q) for q in qs)
        if not qs:
            raise ValueError("need at least one level")
        active = [(n, s) for n, s in sorted(self._names.items())
                  if self._counts[s] > 0]
        if not active:
            return {}
        for name, s in active:
            self._require_full_history(name, s)
        G, Q = len(active), len(qs)
        slots = [s for _, s in active]
        gid_of_slot = {int(s): g for g, s in enumerate(slots)}
        counts = [self._counts[s] for s in slots]

        rows = _gather_rows(self._stacked, self._slot_index(slots))
        kmat = torch.tensor([[local_ops.target_rank(c, q) for q in qs]
                             for c in counts], dtype=torch.int32,
                            device=self.device)
        pivots = sketch_query_rank_batch(rows, kmat)            # (G, Q)
        bound = int(sketch_rank_bound(rows).max())
        n_max = max(counts)
        cap = min(n_max, _round_up(bound + 2, 128))

        if self.fused:
            out = self._segmented_resolve(
                lambda: self._ring_pairs(gid_of_slot), kmat, pivots, cap, G,
                Q, n_max)
        else:
            out = self._rowwise_resolve(gid_of_slot, kmat, pivots, cap, G, Q,
                                        n_max)
        return {name: out[g] for g, (name, _) in enumerate(active)}

    @_query
    def grouped(self, name: str, qs, num_groups: int):
        """Exact quantiles at every level of ``qs`` for all ``num_groups``
        group ids over everything ``ingest_grouped`` buffered, in one job
        (chunks play the shards).  Cold: per-group sketches are rebuilt
        from the chunks (one (key, value) sort each).  Empty groups give
        the dtype's high sentinel.  Returns the (num_groups, len(qs))
        values."""
        st = self._grouped.get(name)
        if st is None or st.n == 0:
            raise ValueError(f"grouped stream {name!r} is empty")
        qs = tuple(float(q) for q in qs)
        G, Q = int(num_groups), len(qs)
        if G < 1 or Q < 1:
            raise ValueError("need num_groups >= 1 and at least one level")

        vals_l, wts_l = [], []
        n_g = torch.zeros((G,), dtype=torch.int32, device=self.device)
        slack = torch.zeros((G,), dtype=torch.int32, device=self.device)
        for v, k in zip(st.chunks, st.key_chunks):
            s = grouped_sketch_samples(self.eps, v.shape[0])
            record_sketch_sort()        # the segmented sketch sorts the chunk
            va, wa, ca, sa = segmented_sketch_local(v, k, G, s)
            vals_l.append(va)
            wts_l.append(wa)
            n_g = n_g + ca
            slack = slack + sa
        g_vals = torch.cat(vals_l, dim=1)
        g_wts = torch.cat(wts_l, dim=1)
        kmat = torch.tensor(
            [[local_ops.exact_target_rank(c, q) for q in qs]
             for c in n_g.tolist()], dtype=torch.int32, device=self.device)
        pivots = query_grouped_sketch(g_vals, g_wts, slack, kmat)

        cap = min(st.n, _round_up(math.ceil(self.eps * st.n) + 2, 128))
        return self._segmented_resolve(
            lambda: zip(st.chunks, st.key_chunks), kmat, pivots, cap, G, Q,
            st.n)

    # -- internals ----------------------------------------------------------

    def _ring_pairs(self, gid_of_slot: Dict[int, int]):
        """(values, keys) flat pairs from the tick ring, one record at a
        time: the keys are each row's group id on its valid lanes and -1 on
        pad lanes and on rows of inactive or dropped streams.  They are
        built on the device from the record's row ids."""
        for rec in self._ring:
            s_tick, length = rec.data.shape
            gids = np.full(s_tick, -1, dtype=np.int32)
            for i in range(s_tick):
                gid = gid_of_slot.get(int(rec.slots[i]))
                if gid is not None and rec.n_valid[i]:
                    gids[i] = gid
            if not (gids >= 0).any():
                continue
            g = torch.from_numpy(gids).to(self.device)
            nv = torch.from_numpy(rec.n_valid).to(self.device)
            lane = torch.arange(length, dtype=torch.int32, device=self.device)
            keys = torch.where(lane < nv.unsqueeze(-1), g.unsqueeze(-1),
                               torch.tensor(-1, dtype=torch.int32,
                                            device=self.device))
            yield rec.data.reshape(-1), keys.reshape(-1)

    def _finish_resolve(self, counts, belows, aboves, kmat, pivots,
                        cap: int, G: int, Q: int):
        """Resolve of the flattened (G, Q) matrix through
        ``engine.phase_resolve``, and the largest realised rank gap, so
        that callers can widen and retry."""
        below = torch.cat([b.reshape(G * Q, -1) for b in belows], dim=-1)
        above = torch.cat([a.reshape(G * Q, -1) for a in aboves], dim=-1)
        flat_c = counts.reshape(G * Q, 3)
        kf = kmat.reshape(G * Q)
        out = engine.phase_resolve(pivots.reshape(G * Q), kf, flat_c, below,
                                   above, cap)
        lt, eq = flat_c[:, 0], flat_c[:, 1]
        need = int(torch.maximum(lt - kf + 1, kf - (lt + eq)).max())
        return out.reshape(G, Q), need

    def _segmented_resolve(self, pairs, kmat, pivots, cap: int,
                           G: int, Q: int, n_limit: int):
        """Count+extract and resolve of a segmented job over the (values,
        keys) chunk pairs that ``pairs()`` yields, widened and rerun if the
        realised gap exceeds the cap.  With ``fused=True`` each pair takes
        one ``segmented_select`` launch per 4096 pivots."""
        seg = (kernel_ops.segmented_count_extract if self.fused
               else local_ops.grouped_count_extract)
        counts = torch.zeros((G, Q, 3), dtype=torch.int32, device=self.device)
        belows, aboves = [], []
        for v, k in pairs():
            c, b, a = seg(v, k, pivots, min(v.shape[0], cap))
            counts = counts + c
            belows.append(b)
            aboves.append(a)
        out, need = self._finish_resolve(counts, belows, aboves, kmat,
                                         pivots, cap, G, Q)
        if need > cap:     # the sketch bound was violated: widen and rerun
            return self._segmented_resolve(
                pairs, kmat, pivots, min(n_limit, _round_up(need + 2, 128)),
                G, Q, n_limit)
        return out

    def _rowwise_resolve(self, gid_of_slot: Dict[int, int], kmat, pivots,
                         cap: int, G: int, Q: int, n_limit: int):
        """``exact_all``'s count+extract straight off the tick ring, one
        row-aligned round per record (each row against its own stream's Q
        pivots), scattered onto the group axis; widened and rerun like
        every other resolve."""
        lo, hi = _sentinels(self.dtype, self.device)
        counts = torch.zeros((G, Q, 3), dtype=torch.int32, device=self.device)
        belows, aboves = [], []
        for rec in self._ring:
            sel = [i for i, s in enumerate(rec.slots)
                   if int(s) in gid_of_slot and rec.n_valid[i]]
            if not sel:
                continue
            gids = self._slot_index([gid_of_slot[int(rec.slots[i])]
                                     for i in sel])
            cap_c = min(rec.data.shape[1], cap)
            c, b, a = _row_count_extract(
                rec.data[self._slot_index(sel)], pivots[gids],
                torch.as_tensor(rec.n_valid[sel], device=self.device), cap_c)
            # a slot appears at most once in a record: the scatter is 1:1
            counts = counts.index_add(0, gids, c)
            belows.append(lo.expand(G, Q, cap_c).clone().index_copy_(
                0, gids, b))
            aboves.append(hi.expand(G, Q, cap_c).clone().index_copy_(
                0, gids, a))
        out, need = self._finish_resolve(counts, belows, aboves, kmat,
                                         pivots, cap, G, Q)
        if need > cap:
            return self._rowwise_resolve(
                gid_of_slot, kmat, pivots,
                min(n_limit, _round_up(need + 2, 128)), G, Q, n_limit)
        return out

    def _window_slices(self, name: str, slot: int, win: Window):
        """The window's population: this stream's ring slices inside the
        window, their count, and the oldest tick the window touches (None
        when it covers the whole retained history).  A window that reaches
        past the retention horizon raises, unless the full history is still
        resident."""
        rows = self._stream_rows(slot)
        total = self._counts[slot]
        retained = self._retained[slot]
        if win.ticks is not None:
            start = self._tick - int(win.ticks)
            horizon = self._tick - (self.window_ticks or self._tick)
            if start < horizon and retained < total:
                raise ValueError(
                    f"window of {win.ticks} ticks reaches past the "
                    f"retention horizon ({self.window_ticks} ticks) for "
                    f"stream {name!r} (retained {retained} of {total} "
                    f"values)")
            slices, n_w = [], 0
            for rec, i, nv in rows:
                if rec.tick >= start:
                    slices.append(rec.data[i, :nv])
                    n_w += nv
            return slices, n_w, (None if n_w == retained else start)
        n_want = int(win.values)
        if n_want >= total and retained == total:
            return [rec.data[i, :nv] for rec, i, nv in rows], total, None
        if n_want > retained:
            raise ValueError(
                f"window of {n_want} values reaches past the retention "
                f"horizon for stream {name!r} (retained {retained} of "
                f"{total} values)")
        slices, remaining, start = [], n_want, None
        for rec, i, nv in reversed(rows):
            take = min(nv, remaining)
            slices.append(rec.data[i, nv - take:nv])
            remaining -= take
            if remaining == 0:
                start = rec.tick
                break
        return list(reversed(slices)), n_want, start

    def _window_pivot(self, slot: int, k: int, n_w: int,
                      start: Optional[int], slices: List[torch.Tensor]):
        """A pivot near window rank ``k`` and the rank-error bound its cap
        comes from.  Warm: merge the sub-window rows whose span meets
        [start, now] (a superset of the window, overcount n_cover - n_w),
        query at k + overcount//2 and widen the bound by
        ceil(overcount/2).  Cold (no sub-window rows): sketch the slices."""
        subs = [s for s in self._subs.get(slot, [])
                if s.n > 0 and (start is None
                                or (s.index + 1) * self._sub_ticks > start)]
        if not subs:
            return self._cold_pivot(slices, k)
        n_cover = sum(s.n for s in subs)
        over = max(0, n_cover - n_w)
        merged = sketch_merge_rows(_gather_rows(
            self._stacked, self._slot_index([s.slot for s in subs])))
        pivot = sketch_query_rank(merged, k + over // 2)
        bound = int(sketch_rank_bound(merged)) + (over + 1) // 2
        return pivot, bound

    def _cold_pivot(self, chunks: List[torch.Tensor], k: int):
        """The stateless job's sketch phase: sketch every chunk from scratch
        (one sort each, ticking ``sketch_sorts``), merge, query."""
        cold = sketch_init(self.budget, self.dtype, self.device)
        for chunk in chunks:
            record_sketch_sort()
            cold = sketch_update(cold, chunk)
        return sketch_query_rank(cold, k), int(sketch_rank_bound(cold))

    def _count_extract_resolve(self, chunks: List[torch.Tensor], n: int,
                               k: int, pivot, cap: int):
        """Count+extract over each chunk (the chunks play the shards; one
        ``fused_select`` launch per chunk with ``fused=True``) and the
        resolve, rerun with a wider cap if the realised gap exceeds it."""
        fn = (kernel_ops.fused_count_extract if self.fused
              else local_ops.fused_count_extract)
        counts, belows, aboves = [], [], []
        for chunk in chunks:
            c, b, a = fn(chunk, pivot, min(chunk.shape[0], cap))
            counts.append(c)
            belows.append(b)
            aboves.append(a)
        total = torch.stack(counts).sum(0, dtype=torch.int32)
        kt = torch.tensor(k, dtype=torch.int32, device=self.device)
        out = local_ops.resolve(pivot, kt, total[0], total[1],
                                torch.cat(belows), torch.cat(aboves), cap)
        lt, eq = total[:2].tolist()
        need = max(lt - k + 1, k - (lt + eq))
        if need > cap:     # the tracked bound was violated: widen and rerun
            return self._count_extract_resolve(
                chunks, n, k, pivot, min(n, _round_up(need + 2, 128)))
        return out

    # -- snapshot / restore -------------------------------------------------

    @_locked("w")
    def snapshot(self):
        """The whole service as ``(leaves, extra)``: a flat leaf list (the
        slot table's four leaves, then per tick record its data, slots and
        n_valid, then each grouped stream's value and key chunks) and
        JSON-able metadata, in the JAX service's format 2.  Staged batches
        are committed first."""
        if self._staged:
            self.commit_staged()
        leaves: List = []
        if self._stacked is not None:
            leaves.extend(self._stacked)
        for rec in self._ring:
            leaves.extend([rec.data, rec.slots, rec.n_valid])
        grouped_meta = {}
        for name in sorted(self._grouped):
            gs = self._grouped[name]
            for v, k in zip(gs.chunks, gs.key_chunks):
                leaves.extend([v, k])
            grouped_meta[name] = {"chunks": len(gs.chunks), "n": gs.n}
        extra = {
            "format": 2,
            "eps": self.eps,
            "budget": self.budget,
            "dtype": _dtype_name(self.dtype),
            "fused": self.fused,
            "check_nans": self.check_nans,
            "has_table": self._stacked is not None,
            "capacity": self._capacity,
            "names": dict(self._names),
            "free": list(self._free),
            "dirty": sorted(self._dirty),
            "counts": list(self._counts),
            "num_ticks": len(self._ring),
            "grouped": grouped_meta,
            "window_ticks": self.window_ticks,
            "window_subs": self.window_subs,
            "tick": self._tick,
            "ring_ticks": [rec.tick for rec in self._ring],
            "retained": list(self._retained),
            "subs": {str(slot): [[s.slot, s.index, s.n] for s in subs]
                     for slot, subs in self._subs.items()},
        }
        return leaves, extra

    @classmethod
    def from_snapshot(cls, leaves, extra, *, fused: Optional[bool] = None,
                      device="cuda") -> "QuantileService":
        """Rebuild a service from ``snapshot()`` output (the port's or the
        JAX service's; leaves as tensors or numpy arrays) on ``device``.
        ``fused`` overrides the saved flag; answers do not depend on it."""
        svc = cls(eps=extra["eps"], budget=extra["budget"],
                  dtype=extra["dtype"],
                  fused=extra["fused"] if fused is None else fused,
                  check_nans=extra["check_nans"],
                  window_ticks=extra.get("window_ticks"),
                  window_subs=extra.get("window_subs", 8), device=device)

        def tensor(a) -> torch.Tensor:
            if not isinstance(a, torch.Tensor):
                a = as_device_tensor(np.asarray(a), "cpu")
            return a.to(svc.device)

        def host_int32(a) -> np.ndarray:
            if isinstance(a, torch.Tensor):
                a = a.cpu().numpy()
            return np.asarray(a).astype(np.int32)

        it = iter(leaves)
        if extra["has_table"]:
            svc._stacked = SketchState(*(tensor(next(it)) for _ in range(4)))
        svc._capacity = int(extra["capacity"])
        svc._names = {str(k): int(v) for k, v in extra["names"].items()}
        svc._free = [int(s) for s in extra["free"]]
        svc._dirty = {int(s) for s in extra["dirty"]}
        svc._counts = [int(c) for c in extra["counts"]]
        num_ticks = int(extra["num_ticks"])
        # format 1 carries no window state: ticks 0..T-1, all retained
        ring_ticks = [int(t) for t in
                      extra.get("ring_ticks", range(num_ticks))]
        svc._tick = int(extra.get("tick", num_ticks))
        svc._retained = [int(c) for c in
                         extra.get("retained", extra["counts"])]
        svc._subs = {
            int(slot): [_SubWindow(slot=int(s), index=int(i), n=int(n))
                        for s, i, n in subs]
            for slot, subs in extra.get("subs", {}).items()}
        for t in ring_ticks:
            data = tensor(next(it))
            slots = host_int32(next(it))
            n_valid = host_int32(next(it))
            svc._ring.append(_TickRecord(data=data, slots=slots,
                                         n_valid=n_valid, tick=t))
        for name, meta in extra["grouped"].items():
            gs = _GroupedStream([], [], int(meta["n"]))
            for _ in range(int(meta["chunks"])):
                gs.chunks.append(tensor(next(it)))
                gs.key_chunks.append(tensor(next(it)))
            svc._grouped[name] = gs
        return svc


class StreamingCalibrator:
    """int8 activation calibration that keeps running |activation| sketches
    across decode steps.

    Each step's activations fold into persistent per-tensor streams of a
    ``QuantileService``, and scales come either approximately in O(s)
    (``approx_scale``) or exactly from a warm query (``scale``): no sketch
    sort at scale-query time.  ``observe_many`` batches all of a step's
    tensors into ONE ingest tick, so the per-step cost stays constant in
    the tensor count.  ``fused=True`` runs each warm query's count+extract
    through ``fused_select``, one launch per ring chunk (per observed step)
    on a CUDA device.

    ``ingest_threads`` > 0 opts into the threaded ingest pipeline
    (``ingest_pool.IngestPool``): ``observe_many`` becomes a queue handoff
    so that calibration stops taking decode-loop time, ``scale()`` flushes
    first (still exact up to now), and ``approx_scale`` reads the folded
    state without a barrier, stale by at most the pool's ``lag_values()``.
    ``None`` reads ``REPRO_INGEST_THREADS`` (default 0 = synchronous).
    Call ``close()`` (or use it as a context manager) when threaded.
    ``device`` holds the service (``"cuda"`` without a card raises)."""

    def __init__(self, q: float = 0.999, *, eps: float = 0.01,
                 fused: bool = False, ingest_threads: Optional[int] = None,
                 device="cuda"):
        self.q = q
        self.service = QuantileService(eps=eps, fused=fused, device=device)
        if ingest_threads is None:
            from .ingest_pool import default_ingest_workers
            ingest_threads = (default_ingest_workers()
                              if "REPRO_INGEST_THREADS" in os.environ else 0)
        self.pool = None
        if ingest_threads:
            from .ingest_pool import IngestPool
            self.pool = IngestPool(self.service, workers=ingest_threads)

    def observe(self, name: str, activations) -> None:
        self.observe_many({name: activations})

    def observe_many(self, named: Dict[str, object]) -> None:
        """Fold one decode step's activations, every tensor at once, into
        the per-tensor streams: ONE ingest tick however many tensors the
        step observed (|x| in f32 applied on the service's device).
        Threaded mode queues the tensors instead (|x| applied host-side in
        the worker thread, the same bits) and returns at once."""
        if not named:
            return
        names = sorted(named)
        if self.pool is not None:
            for n in names:
                self.pool.submit(n, named[n], transform="abs_f32")
            return
        self.service.ingest_batch(names, [named[n] for n in names],
                                  transform="abs_f32")

    def scale(self, name: str):
        """Exact symmetric int8 scale: warm GK Select over everything
        observed so far.  Threaded mode flushes the pool first, so 'so far'
        includes every queued step."""
        self.flush()
        return self.service.exact(name, self.q)

    def approx_scale(self, name: str):
        """O(s) scale estimate from the sketch alone (rank error within
        ``service.rank_bound(name)``), for per-step monitoring.  Threaded
        mode does NOT flush: it reads the folded state, stale by at most
        ``pool.lag_values()`` queued values."""
        return self.service.approx(name, self.q)

    def observed(self, name: str) -> int:
        """Values folded for ``name`` (flushes first in threaded mode, so
        that the count covers every queued observation)."""
        self.flush()
        return self.service.stream_count(name)

    def flush(self) -> None:
        """Barrier for threaded mode (no-op when synchronous)."""
        if self.pool is not None:
            self.pool.flush()

    def close(self) -> None:
        """Stop the ingest pool, folding everything queued (no-op when
        synchronous).  Idempotent."""
        if self.pool is not None:
            self.pool.close()

    def __enter__(self) -> "StreamingCalibrator":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        try:
            self.close()
        except BaseException:
            if exc_type is None:
                raise
