"""IngestPool: threaded concurrent ingest for the port's QuantileService.

Counterpart of ``repro/launch/ingest_pool.py``.  N ingest workers each own
a private ``QuantileService.local_buffer()`` and stage submitted batches
into it host-side (a list append; a CUDA tensor is copied to the host in
the worker, which waits on the stream there, not in the producer).  When a
buffer holds ``epoch_values`` values the worker hands it to the fold
thread over a bounded queue and goes on with a fresh buffer.  The fold
thread drains up to ``fold_batch`` buffers per wake-up and lands them in
ONE ``QuantileService.fold_many`` call (one ingest tick, device work on
the service's device), so the device-step overhead is paid once per epoch
batch instead of once per submitted batch.

Concurrency discipline:

* submits are routed round-robin and block only when the target worker's
  bounded queue is full (backpressure, default ``queue_depth`` items);
* queries (``approx``/``exact``/``exact_all``) go straight to the shared
  service at any time; its reader-writer lock lets them overlap each
  other and serialises them only against folds;
* staleness bound: a submitted value is invisible to queries for at most
  one epoch (its buffer's remaining capacity) plus the fold queue it is
  behind; ``lag_values()`` reports the gap, ``flush()`` is the barrier
  that drives it to zero;
* ``exact*`` answers after ``flush()`` are bit-identical to a serial
  ingest of the same batches in ANY order: exact quantiles are rank
  selection on a multiset, so thread scheduling cannot change them.

Worker errors (e.g. the NaN reject policy tripping in ``stage``) are
captured and re-raised on the next ``submit``/``flush``/``close``; the
failed items' values are credited as folded so that accounting, and any
in-flight ``flush``, still converges instead of deadlocking.
"""
from __future__ import annotations

import itertools
import os
import queue
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .quantile_service import QuantileService

__all__ = ["IngestPool", "default_ingest_workers"]

_STOP = object()    # sentinel: worker/folder shutdown
_FLUSH = object()   # sentinel: hand off the current buffer even if partial


def default_ingest_workers() -> int:
    """Worker count from ``REPRO_INGEST_THREADS``, else ``min(4, cores)``.

    ``0`` is a valid setting — callers with a synchronous path (e.g.
    ``StreamingCalibrator``) read it as "no pool"."""
    env = os.environ.get("REPRO_INGEST_THREADS")
    if env is not None:
        n = int(env)
        if n < 0:
            raise ValueError(f"REPRO_INGEST_THREADS must be >= 0, got {n}")
        return n
    return min(4, os.cpu_count() or 1)


class IngestPool:
    """N threaded ingest workers + a fold scheduler over one service.

    Parameters
    ----------
    service:       the shared ``QuantileService`` folds land in.  Query
                   it directly (also from other threads) at any time.
    workers:       ingest thread count (default: ``REPRO_INGEST_THREADS``
                   env var, else ``min(4, cores)``; must be >= 1 here).
    epoch_values:  buffer handoff threshold — a worker hands its buffer
                   to the fold scheduler once this many values are
                   staged.  The staleness bound is one epoch.
    fold_batch:    max buffers merged per ``fold_many`` call (device
                   cost is ONE dispatch regardless); default = workers.
    queue_depth:   bounded per-worker queue length — ``submit`` blocks
                   (backpressure) when the target worker is this far
                   behind.
    gather_timeout: how long the fold thread waits to assemble a FULL
                   ``fold_batch`` before folding what it has: fewer,
                   larger folds pay the per-tick device overhead less
                   often.  The timeout only bites at the tail of a
                   drain.

    Use as a context manager, or call ``close()`` — it drains every
    queued batch before returning."""

    def __init__(self, service: QuantileService, *,
                 workers: Optional[int] = None,
                 epoch_values: int = 4096,
                 fold_batch: Optional[int] = None,
                 queue_depth: int = 64,
                 gather_timeout: float = 0.05) -> None:
        if workers is None:
            workers = max(1, default_ingest_workers())
        if workers < 1:
            raise ValueError(f"need at least one worker, got {workers}")
        if epoch_values < 1:
            raise ValueError(f"epoch_values must be >= 1, got {epoch_values}")
        if queue_depth < 1:
            raise ValueError(f"queue_depth must be >= 1, got {queue_depth}")
        self.service = service
        self.workers = int(workers)
        self.epoch_values = int(epoch_values)
        self.fold_batch = int(fold_batch) if fold_batch else self.workers
        if self.fold_batch < 1:
            raise ValueError(f"fold_batch must be >= 1, got {self.fold_batch}")
        self.gather_timeout = float(gather_timeout)

        self._queues: List[queue.Queue] = [
            queue.Queue(maxsize=queue_depth) for _ in range(self.workers)]
        # Bounded too: if the folder falls behind, handoffs block, then
        # worker queues fill, then submit blocks — backpressure all the
        # way up to the producer instead of unbounded buffer pile-up.
        self._fold_q: queue.Queue = queue.Queue(
            maxsize=max(4, 2 * self.workers))
        self._rr = itertools.count()

        # _submitted/_folded are in VALUES (not batches); _folded also
        # absorbs discarded values after an error so flush() converges.
        self._cond = threading.Condition()
        self._submitted = 0
        self._folded = 0
        self._max_lag = 0
        self._folds = 0
        self._buffers_folded = 0
        self._errors: List[BaseException] = []
        self._closed = False

        self._threads = [
            threading.Thread(target=self._worker_loop, args=(i,),
                             name=f"repro-ingest-{i}", daemon=True)
            for i in range(self.workers)]
        self._fold_thread = threading.Thread(
            target=self._fold_loop, name="repro-fold", daemon=True)
        for t in self._threads:
            t.start()
        self._fold_thread.start()

    # -- producer API --------------------------------------------------------

    def submit(self, name: str, values, *,
               transform: Optional[str] = None) -> None:
        """Queue one batch for stream ``name``.  Near-free for the caller:
        the batch crosses a bounded queue and is staged host-side by a
        worker thread; device work happens at fold time.  Blocks only
        under backpressure.  ``transform`` names a host-mirrored device
        transform (e.g. ``"abs_f32"``), applied in the worker thread."""
        if self._closed:
            raise RuntimeError("submit on closed IngestPool")
        self._check_errors()
        # Only the count is read here: a CUDA tensor is NOT copied to the
        # host in the producer thread; the worker's stage() call does the
        # transfer off the critical path.
        if isinstance(values, torch.Tensor):
            count = values.numel()
        else:
            values = np.asarray(values)
            count = int(values.size)
        if count == 0:
            return
        q = self._queues[next(self._rr) % self.workers]
        q.put((name, values, transform, count))
        # Counted only AFTER the put: anything included in a flush()
        # target snapshot is therefore already enqueued ahead of the
        # flush tokens (FIFO per worker), so the barrier cannot miss it.
        with self._cond:
            self._submitted += count
            lag = self._submitted - self._folded
            if lag > self._max_lag:
                self._max_lag = lag

    def flush(self, timeout: Optional[float] = None) -> None:
        """Barrier: every value submitted before this call is folded into
        the shared service when it returns — ``exact*`` is then exact up
        to now, bit-identical to a serial ingest of the same batches.
        Partial buffers are handed off (the epoch cadence resumes after).
        Raises the first worker/fold error instead of hanging."""
        self._check_errors()
        with self._cond:
            target = self._submitted
        for q in self._queues:
            q.put(_FLUSH)
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while self._folded < target and not self._errors:
                if deadline is not None and time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"IngestPool.flush: {target - self._folded} values "
                        f"still unfolded after {timeout:.1f}s")
                self._cond.wait(timeout=0.1)
        self._check_errors()

    def close(self) -> None:
        """Drain everything queued, fold it, stop all threads.  Idempotent.
        Re-raises the first captured worker/fold error (if any)."""
        if self._closed:
            return
        self._closed = True
        for q in self._queues:
            q.put(_STOP)
        for t in self._threads:
            t.join()
        self._fold_q.put(_STOP)
        self._fold_thread.join()
        self._check_errors()

    def __enter__(self) -> "IngestPool":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        try:
            self.close()
        except BaseException:
            if exc_type is None:   # don't mask the in-flight exception
                raise

    # -- observability -------------------------------------------------------

    def lag_values(self) -> int:
        """Values submitted but not yet folded — the instantaneous
        staleness of queries on the shared service (<= one epoch per
        worker plus queued buffers; 0 right after ``flush()``)."""
        with self._cond:
            return self._submitted - self._folded

    def stats(self) -> Dict[str, float]:
        with self._cond:
            submitted, folded = self._submitted, self._folded
            max_lag = self._max_lag
            folds, buffers = self._folds, self._buffers_folded
        return {
            "workers": self.workers,
            "epoch_values": self.epoch_values,
            "fold_batch": self.fold_batch,
            "submitted_values": submitted,
            "folded_values": folded,
            "lag_values": submitted - folded,
            "max_lag_values": max_lag,
            "folds": folds,
            "buffers_folded": buffers,
            "avg_buffers_per_fold": (buffers / folds) if folds else 0.0,
        }

    # -- internals -----------------------------------------------------------

    def _check_errors(self) -> None:
        if self._errors:
            raise self._errors[0]

    def _fail(self, exc: BaseException) -> None:
        with self._cond:
            self._errors.append(exc)
            self._cond.notify_all()

    def _credit(self, count: int) -> None:
        with self._cond:
            self._folded += count
            self._cond.notify_all()

    def _worker_loop(self, index: int) -> None:
        q = self._queues[index]
        buf = self.service.local_buffer()
        failed = False
        while True:
            item = q.get()
            if item is _STOP:
                if not failed and buf.staged_count:
                    self._fold_q.put((buf, buf.staged_count))
                return
            if item is _FLUSH:
                if not failed and buf.staged_count:
                    self._fold_q.put((buf, buf.staged_count))
                    buf = self.service.local_buffer()
                continue
            name, arr, transform, count = item
            if failed:
                self._credit(count)
                continue
            try:
                buf.stage(name, arr, transform=transform)
            except BaseException as exc:   # noqa: BLE001 — must not die silently
                self._fail(exc)
                failed = True
                # This item's values AND everything staged in the now-
                # discarded buffer are lost — credit them so flush()
                # and close() converge instead of waiting forever.
                self._credit(count + buf.staged_count)
                continue
            if buf.staged_count >= self.epoch_values:
                self._fold_q.put((buf, buf.staged_count))
                buf = self.service.local_buffer()

    def _fold_loop(self) -> None:
        while True:
            item = self._fold_q.get()
            if item is _STOP:
                return
            pending: List[Tuple[QuantileService, int]] = [item]
            stop_after = False
            while len(pending) < self.fold_batch:
                # Wait (briefly) for a FULL batch: fewer, larger folds
                # beat eager partial folds (see gather_timeout above).
                try:
                    nxt = self._fold_q.get(timeout=self.gather_timeout)
                except queue.Empty:
                    break
                if nxt is _STOP:
                    stop_after = True
                    break
                pending.append(nxt)
            credit = sum(c for _, c in pending)
            try:
                self.service.fold_many([b for b, _ in pending])
            except BaseException as exc:   # noqa: BLE001
                self._fail(exc)
            finally:
                with self._cond:
                    self._folded += credit
                    self._folds += 1
                    self._buffers_folded += len(pending)
                    self._cond.notify_all()
            if stop_after:
                return
