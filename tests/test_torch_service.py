"""The port's ``QuantileService`` against the JAX package's, bit for bit.

The scripted sequence of ``tests/_service_script.py`` runs through both
packages in float32 with ``fused`` both ways (bfloat16, int32, float64 and
the windowed sequence: ``test_torch_service_grid.py``,
``test_torch_service_windowed.py``).  Snapshots then cross the packages
both ways through ``save_service_snapshot``/``restore_service_snapshot``,
with the same warm ``exact()``, ``exact_all()``, ``grouped()`` and
windowed answers on each side and no history replay.
"""
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.checkpoint as jck                                # noqa: E402
import repro.core.sketch as jsk                               # noqa: E402
import repro_torch.checkpoint as tck                          # noqa: E402
import repro_torch.core.sketch as tsk                         # noqa: E402
import repro_torch.launch.quantile_service as tqs             # noqa: E402
from _service_script import (JAX, NAMES, TORCH, _assert_same,  # noqa: E402
                             _bytes, _jax_record, _tick, _values, script)


@pytest.mark.parametrize("fused", [False, True])
def test_scripted_sequence_matches_jax(fused):
    _assert_same(_jax_record(script, "float32", fused),
                 script(TORCH, "float32", fused), fused)


def _filled(api, dtype, **kw):
    svc = api.svc(eps=0.05, dtype=api.dtype(dtype), **kw, **api.kw)
    for t in range(4):
        svc.ingest_batch(NAMES, _tick(dtype, t))
    svc.drop_stream("d")
    svc.ingest_grouped("g", _values(dtype, 64, 9),
                       np.arange(64, dtype=np.int32) % 3)
    return svc


def _answers(svc):
    return _bytes({**{n: svc.exact(n, 0.37) for n in ("a", "b", "c")},
                   **{f"all {n}": v for n, v in
                      svc.exact_all((0.2, 0.8)).items()},
                   "grouped": svc.grouped("g", (0.5,), 3)})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_snapshots_cross_the_packages(dtype, tmp_path):
    """A JAX snapshot restores in the port and the reverse, with the same
    warm answers on each side and no history replay."""
    want = _answers(_filled(JAX, dtype))

    jck.save_service_snapshot(str(tmp_path / "jax"), 3, _filled(JAX, dtype))
    tsk.reset_sketch_sorts()
    from_jax = tck.restore_service_snapshot(str(tmp_path / "jax"),
                                            device="cpu")
    got = {n: from_jax.exact(n, 0.37) for n in ("a", "b", "c")}
    assert tsk.sketch_sorts() == 0                  # warm: no replay
    assert _bytes(got) == {k: v for k, v in want.items() if len(k) == 1}
    assert _answers(from_jax) == want

    tck.save_service_snapshot(str(tmp_path / "torch"), 4,
                              _filled(TORCH, dtype), keep=1)
    jsk.reset_sketch_sorts()
    from_torch = jck.restore_service_snapshot(str(tmp_path / "torch"))
    got = {n: from_torch.exact(n, 0.37) for n in ("a", "b", "c")}
    assert jsk.sketch_sorts() == 0
    assert _bytes(got) == {k: v for k, v in want.items() if len(k) == 1}
    assert _answers(from_torch) == want

    # windowed state crosses too, and a format-1 snapshot (no window keys)
    # reads as an unwindowed service in both packages
    j = _filled(JAX, dtype, window_ticks=3, window_subs=2)
    jck.save_service_snapshot(str(tmp_path / "jw"), 1, j)
    tw = tck.restore_service_snapshot(str(tmp_path / "jw"), device="cpu")
    for name in ("a", "c"):
        assert _bytes(tw.windowed(name, 0.5, window=2)) == _bytes(
            j.windowed(name, 0.5, window=2))
        assert _bytes(tw.approx_decayed(name, 0.5, halflife=1.5)) == _bytes(
            j.approx_decayed(name, 0.5, halflife=1.5))
    leaves, extra = _filled(JAX, dtype).snapshot()
    for key in ("format", "window_ticks", "window_subs", "tick",
                "ring_ticks", "retained", "subs"):
        extra.pop(key)
    old = tqs.QuantileService.from_snapshot(
        [np.asarray(x) for x in leaves], extra, device="cpu")
    assert old.window_ticks is None
    assert _answers(old) == want


def test_checkpoint_retention_and_layout(tmp_path):
    leaves = [torch.arange(6, dtype=torch.float32).reshape(2, 3),
              torch.tensor([1.5, -0.0], dtype=torch.bfloat16),
              np.array([3, -1], np.int32)]
    for step in (1, 2, 3, 4):
        tck.save_checkpoint(str(tmp_path), step, leaves, {"k": step}, keep=2)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_0000000003", "step_0000000004"]
    assert tck.latest_step(str(tmp_path)) == 4
    assert tck.latest_step(str(tmp_path / "missing")) is None
    back, extra = tck.restore_checkpoint_flat(str(tmp_path))
    assert extra == {"k": 4}
    for a, b in zip(leaves, back):
        assert _bytes(torch.as_tensor(a)) == _bytes(b)
    # the JAX package reads the same files, leaf paths and all
    jleaves, jextra = jck.restore_checkpoint_flat(str(tmp_path), 3)
    assert jextra == {"k": 3}
    for a, b in zip(leaves, jleaves):
        assert _bytes(torch.as_tensor(a))[3] == _bytes(b)[3]
    with pytest.raises(FileNotFoundError):
        tck.restore_checkpoint_flat(str(tmp_path / "missing"))
    with pytest.raises(ValueError):
        tck.restore_service_snapshot(str(tmp_path))


def test_queries_overlap_ingest_on_threads():
    """Readers, writers and stagers on more threads than cores, with a
    short switch interval: every thread is joined with a time limit, no
    counter tick is lost, and the answers equal a serial replay."""
    import os
    import sys
    svc = TORCH.svc(eps=0.05, **TORCH.kw)
    serial = TORCH.svc(eps=0.05, **TORCH.kw)
    TORCH.reset()
    errors = []
    workers = max(8, 2 * (os.cpu_count() or 1))

    def reader():
        # bounded, with pauses: the lock lets readers starve a writer (as
        # the JAX service's does), so a saturating read loop would stall
        try:
            for _ in range(20):
                time.sleep(0.002)
                if svc.stream_count("a0"):
                    svc.exact("a0", 0.5, commit=False)
                    svc.exact_all((0.5,), commit=False)
        except Exception as e:           # surfaced below
            errors.append(e)

    def writer(w):
        try:
            for t in range(3):
                svc.ingest_batch([f"{n}{w}" for n in NAMES],
                                 _tick("float32", 10 * w + t))
        except Exception as e:
            errors.append(e)

    readers = [threading.Thread(target=reader) for _ in range(workers // 2)]
    writers = [threading.Thread(target=writer, args=(w,))
               for w in range(workers // 2)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for th in readers + writers:
            th.start()
        for th in readers + writers:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in readers + writers)
    assert not errors
    counts = TORCH.counters()          # (sketch_sorts, ingest_dispatches)
    assert len(svc._ring) == 3 * (workers // 2)
    TORCH.reset()
    for w in range(workers // 2):
        for t in range(3):
            serial.ingest_batch([f"{n}{w}" for n in NAMES],
                                _tick("float32", 10 * w + t))
    assert TORCH.counters() == counts   # no tick lost
    names = sorted(svc.streams())
    assert names == sorted(serial.streams())
    assert _bytes({n: svc.exact(n, 0.3) for n in names if
                   svc.stream_count(n)}) == _bytes(
        {n: serial.exact(n, 0.3) for n in names if serial.stream_count(n)})


def test_tensors_must_be_on_the_service_device():
    svc = TORCH.svc(**TORCH.kw)
    meta = torch.zeros(3, device="meta")
    with pytest.raises(ValueError, match="device"):
        svc.ingest("a", meta)
    with pytest.raises(ValueError, match="device"):
        svc.ingest_grouped("g", meta, torch.zeros(3, dtype=torch.int32))


def test_segmented_launches_split_by_pivot_limit(monkeypatch):
    """A (G, Q) grid wider than one ``segmented_select`` launch takes goes
    in group slices (``kernels.ops.segmented_count_extract``); the answers
    are the unsplit job's, through the service and the grouped engine."""
    import repro_torch
    from repro_torch.kernels import ops, segmented_select
    svc = TORCH.svc(eps=0.05, fused=True, **TORCH.kw)
    for t in range(3):
        svc.ingest_batch(NAMES, _tick("float32", t))
    svc.ingest_grouped("g", _values("float32", 64, 3),
                       np.arange(64, dtype=np.int32) % 5 - 1)
    parts = torch.from_numpy(_values("float32", 96, 4).reshape(3, 32))
    keys = torch.arange(96, dtype=torch.int32).reshape(3, 32) % 7 - 1

    def answers():
        return _bytes([svc.exact_all((0.1, 0.5, 0.9)),
                       svc.grouped("g", (0.5, 0.75, 1.0), 4),
                       repro_torch.gk_select_grouped(
                           parts, keys, (0.2, 0.9), num_groups=6,
                           block_select=True)])

    want = answers()
    ops.reset_hbm_passes()
    ops.segmented_count_extract(parts, keys, torch.zeros(6, 2), 8)
    assert ops.hbm_passes() == 3 * 6 * 2
    for limit in (3, 4, 7):
        monkeypatch.setattr(segmented_select, "MAX_PIVOTS", limit)
        assert answers() == want
    ops.reset_hbm_passes()
    ops.segmented_count_extract(parts, keys, torch.zeros(6, 2), 8)
    assert ops.hbm_passes() == 3 * 6 * 2 + 1          # 2 slices of 3 groups
