"""The port's threaded ingest (``repro_torch.launch.IngestPool``) against
serial ingest and against the JAX package's pool, bit for bit.

After ``flush`` every ``exact``/``exact_all`` answer equals a serial ingest
of the same batches and the JAX pool's answers: exact quantiles are rank
selection on a multiset, so thread scheduling cannot change them.  With one
worker and one buffer a fold, every batch lands as its own tick in order,
so ``approx`` is the serial ingest's bits too; with more workers the fold
grouping depends on timing and ``approx`` is held to its rank bound.  Also:
NaN re-raised on the next ``submit``/``flush``/``close`` while ``flush``
still converges, backpressure at ``queue_depth=1``, ``close`` idempotent,
the ``REPRO_INGEST_THREADS`` default, and a stress run with more threads
than cores.  Every thread is joined with a time limit and the test fails
past it (``pytest-timeout`` is not installed).
"""
import os
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.launch import IngestPool as JIngestPool               # noqa: E402
from repro.launch import QuantileService as JService             # noqa: E402
from repro_torch.launch import (IngestPool, QuantileService,     # noqa: E402
                                default_ingest_workers)

EPS, BUDGET = 0.05, 64
QS = (0.1, 0.5, 0.99)
LIMIT_S = 120


def tb(t):
    return t.contiguous().view(torch.int32).numpy().tobytes()


def jb(a):
    return np.asarray(a).tobytes()


def _mk(**kw):
    kw.setdefault("eps", EPS)
    kw.setdefault("budget", BUDGET)
    return QuantileService(device="cpu", **kw)


def _jmk():
    return JService(eps=EPS, budget=BUDGET)


def _batches(seed, n_streams=4, n_batches=24, size=128):
    rng = np.random.default_rng(seed)
    return [(f"s{i % n_streams}",
             rng.normal(size=size).astype(np.float32))
            for i in range(n_batches)]


def _serial(batches):
    svc = _mk()
    for name, b in batches:
        svc.ingest_batch([name], [b])
    return svc


def _join(threads, limit=LIMIT_S):
    deadline = time.monotonic() + limit
    for t in threads:
        t.join(timeout=max(0.0, deadline - time.monotonic()))
    alive = [t.name for t in threads if t.is_alive()]
    assert not alive, f"threads still running after {limit} s: {alive}"


def _close(pool, limit=LIMIT_S):
    """``pool.close()`` within ``limit`` seconds; its threads must end."""
    errs = []

    def run():
        try:
            pool.close()
        except BaseException as exc:          # noqa: BLE001 — re-raised
            errs.append(exc)
    t = threading.Thread(target=run, name="close")
    t.start()
    _join([t], limit)
    _join(pool._threads + [pool._fold_thread], 1)
    if errs:
        raise errs[0]


def _assert_exact_parity(got, ref):
    names = sorted(ref.streams())
    assert sorted(got.streams()) == names
    g, w = got.exact_all(QS), ref.exact_all(QS)
    for n in names:
        assert got.stream_count(n) == ref.stream_count(n)
        assert tb(g[n]) == tb(w[n]), n
        for q in QS:
            assert tb(got.exact(n, q)) == tb(ref.exact(n, q)), (n, q)


def _jax_pool_answers(batches, workers, **kw):
    svc = _jmk()
    pool = JIngestPool(svc, workers=workers, **kw)
    try:
        for name, b in batches:
            pool.submit(name, b)
        pool.flush(timeout=LIMIT_S)
    finally:
        pool.close()
    return svc


@pytest.mark.parametrize("workers", [1, 4])
def test_flush_then_queries_match_serial_and_jax(workers):
    batches = _batches(0)
    kw = (dict(epoch_values=1, fold_batch=1) if workers == 1
          else dict(epoch_values=512))
    svc = _mk()
    pool = IngestPool(svc, workers=workers, **kw)
    try:
        for name, b in batches:
            pool.submit(name, b)
        pool.flush(timeout=LIMIT_S)
        assert pool.lag_values() == 0
    finally:
        _close(pool)
    ref = _serial(batches)
    _assert_exact_parity(svc, ref)
    jsvc = _jax_pool_answers(batches, workers, **kw)
    got, want = svc.exact_all(QS), jsvc.exact_all(QS)
    for n in sorted(ref.streams()):
        assert tb(got[n]) == jb(want[n]), n
        assert svc.stream_count(n) == jsvc.stream_count(n)
        for q in QS:
            a = svc.approx(n, q)
            if workers == 1:        # one tick per batch, in order
                assert tb(a) == tb(ref.approx(n, q)) == jb(jsvc.approx(n, q))
            else:                   # fold grouping is timing's: the bound
                vals = np.sort(np.concatenate([b for m, b in batches
                                               if m == n]))
                rank = np.searchsorted(vals, float(a), side="right")
                k = max(1, int(np.ceil(q * vals.size)))
                assert abs(rank - k) <= svc.rank_bound(n) + 1, (n, q)


def test_close_drains_without_explicit_flush():
    batches = _batches(1)
    svc = _mk()
    pool = IngestPool(svc, workers=2, epoch_values=10 ** 6)
    for name, b in batches:
        pool.submit(name, b)
    _close(pool)              # everything queued must fold on close
    _assert_exact_parity(svc, _serial(batches))


def test_transform_and_tensor_batches_match_the_synchronous_path():
    rng = np.random.default_rng(2)
    chunks = [rng.normal(size=200).astype(np.float64) for _ in range(4)]
    chunks += [torch.from_numpy(rng.normal(size=(3, 50)).astype(np.float32))
               for _ in range(4)]
    sync = _mk()
    for c in chunks:
        sync.ingest_batch(["t"], [c], transform="abs_f32")
    svc = _mk()
    pool = IngestPool(svc, workers=3, epoch_values=512)
    try:
        for c in chunks:
            pool.submit("t", c, transform="abs_f32")
        pool.flush(timeout=LIMIT_S)
    finally:
        _close(pool)
    _assert_exact_parity(svc, sync)


def test_nan_is_reraised_on_submit_flush_and_close():
    svc = _mk()
    pool = IngestPool(svc, workers=1, epoch_values=10 ** 6)
    pool.submit("ok", np.ones(50, dtype=np.float32))
    pool.submit("bad", np.array([1.0, np.nan], dtype=np.float32))
    pool.submit("after", np.ones(30, dtype=np.float32))
    with pytest.raises(ValueError, match="NaN"):
        pool.flush(timeout=LIMIT_S)   # raises, does not hang on lost values
    assert pool.lag_values() == 0     # the lost values are credited
    with pytest.raises(ValueError, match="NaN"):
        pool.submit("x", np.ones(4, dtype=np.float32))
    with pytest.raises(ValueError, match="NaN"):
        _close(pool)


def test_backpressure_blocks_submit_at_queue_depth_one():
    release = threading.Event()
    svc = _mk()

    class SlowBuffer(QuantileService):
        def stage(self, *args, **kwargs):
            release.wait(LIMIT_S)
            return super().stage(*args, **kwargs)

    svc.local_buffer = lambda: SlowBuffer(eps=EPS, budget=BUDGET,
                                          device="cpu")
    pool = IngestPool(svc, workers=1, epoch_values=10 ** 6, queue_depth=1)
    try:
        pool.submit("x", np.ones(4, dtype=np.float32))   # the worker takes it
        deadline = time.monotonic() + LIMIT_S
        while pool._queues[0].qsize() and time.monotonic() < deadline:
            time.sleep(0.01)
        pool.submit("x", np.ones(4, dtype=np.float32))   # fills the queue
        third = threading.Thread(
            target=pool.submit, args=("x", np.ones(4, dtype=np.float32)),
            name="third-submit")
        third.start()
        third.join(timeout=0.3)
        assert third.is_alive(), "submit did not block on a full queue"
        release.set()
        _join([third])
        pool.flush(timeout=LIMIT_S)
        assert svc.stream_count("x") == 12
    finally:
        release.set()
        _close(pool)


def test_close_is_idempotent_and_final():
    svc = _mk()
    pool = IngestPool(svc, workers=2)
    pool.submit("x", np.ones(8, dtype=np.float32))
    _close(pool)
    _close(pool)                  # idempotent
    assert svc.stream_count("x") == 8
    with pytest.raises(RuntimeError, match="closed"):
        pool.submit("x", np.ones(4, dtype=np.float32))
    with IngestPool(svc, workers=1) as ctx:
        ctx.submit("y", np.ones(3, dtype=np.float32))
    assert svc.stream_count("y") == 3 and not ctx._fold_thread.is_alive()


def test_default_workers_env(monkeypatch):
    monkeypatch.setenv("REPRO_INGEST_THREADS", "3")
    assert default_ingest_workers() == 3
    pool = IngestPool(_mk())
    assert pool.workers == 3
    _close(pool)
    monkeypatch.delenv("REPRO_INGEST_THREADS")
    assert default_ingest_workers() == min(4, os.cpu_count() or 1)
    monkeypatch.setenv("REPRO_INGEST_THREADS", "-1")
    with pytest.raises(ValueError):
        default_ingest_workers()
    for bad in (dict(workers=0), dict(workers=1, epoch_values=0),
                dict(workers=1, queue_depth=0)):
        with pytest.raises(ValueError):
            IngestPool(_mk(), **bad)


def test_stress_more_threads_than_cores_with_queries():
    """More producers than cores, a query thread and a short switch
    interval; after flush the state equals a serial ingest's."""
    n_producers = max(4, (os.cpu_count() or 1) + 2)
    rng = np.random.default_rng(6)
    plans = [[(f"p{t}_{i % 3}", rng.normal(size=64).astype(np.float32))
              for i in range(6)] for t in range(n_producers)]
    svc = _mk()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        pool = IngestPool(svc, workers=3, epoch_values=192, queue_depth=2)
        errs, stop = [], threading.Event()

        def producer(plan):
            try:
                for name, b in plan:
                    pool.submit(name, b)
            except Exception as e:     # pragma: no cover - failure path
                errs.append(e)

        def reader():
            try:
                while not stop.is_set():
                    for n in list(svc.streams())[:2]:
                        svc.approx(n, 0.5)
                        svc.exact(n, 0.5)
            except Exception as e:     # pragma: no cover - failure path
                errs.append(e)

        producers = [threading.Thread(target=producer, args=(p,),
                                      name=f"producer{i}")
                     for i, p in enumerate(plans)]
        query = threading.Thread(target=reader, name="reader")
        for t in producers + [query]:
            t.start()
        _join(producers)
        pool.flush(timeout=LIMIT_S)
        stop.set()
        _join([query])
        _close(pool)
    finally:
        sys.setswitchinterval(old)
    assert not errs, errs
    ref = _mk()
    for plan in plans:
        for name, b in plan:
            ref.ingest_batch([name], [b])
    _assert_exact_parity(svc, ref)
