"""The scripted service sequences that ``tests/test_torch_service*.py``
run through ``repro.launch.QuantileService`` and through
``repro_torch.QuantileService(device="cpu")``, and their comparison.

``script`` drives ragged ``ingest_batch`` ticks of host and device inputs
and the ``abs_f32`` transform, ``drop_stream`` and a recycled slot,
``approx``, ``exact`` warm and cold, ``exact_all``, ``ingest_grouped`` and
``grouped``, ``stage``/``commit_staged`` and ``commit=False``,
``fold_many`` of staged worker buffers and of a materialised one, the
error cases (the exception type is the answer) and the counters
``sketch_sorts`` and ``ingest_dispatches``; ``windowed_script`` drives a
windowed service (``window_ticks=6, window_subs=3``): ``windowed`` over
tick and value windows, ``window_count``, ``approx_decayed``,
``memory_stats`` as history slides out, the horizon errors.  Both end with
the service's snapshot.  Tolerance is zero: arrays compare as raw bytes.
"""
import contextlib
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402

from _grid import _np_dtype                                   # noqa: E402
import repro.core.sketch as jsk                               # noqa: E402
import repro.launch.quantile_service as jqs                   # noqa: E402
import repro_torch.core.sketch as tsk                         # noqa: E402
import repro_torch.launch.quantile_service as tqs             # noqa: E402
from repro_torch.core.select import as_device_tensor          # noqa: E402

NAMES = ["a", "b", "c", "d"]
LENS = (0, 7, 33, 64)           # few distinct shapes keep JAX's traces few


def _x64(dtype):
    return (jax.enable_x64(True) if dtype == "float64"
            else contextlib.nullcontext())


def _bytes(x):
    """A comparable record of an answer of either package."""
    if isinstance(x, torch.Tensor):
        view = {1: torch.int8, 2: torch.int16, 4: torch.int32,
                8: torch.int64}[x.element_size()]
        name = str(x.dtype).replace("torch.", "")
        return ("array", name, tuple(x.shape),
                x.detach().contiguous().view(view).cpu().numpy().tobytes())
    if isinstance(x, (jax.Array, np.ndarray)):
        a = np.asarray(x)
        return ("array", a.dtype.name, a.shape, a.tobytes())
    if isinstance(x, dict):
        return {k: _bytes(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_bytes(v) for v in x]
    return x


JAX = types.SimpleNamespace(
    name="jax", svc=jqs.QuantileService, Window=jqs.Window,
    dev=lambda a: jnp.asarray(a), dtype=lambda d: jnp.dtype(_np_dtype(d)),
    reset=lambda: (jsk.reset_sketch_sorts(), jqs.reset_ingest_dispatches()),
    counters=lambda: (jsk.sketch_sorts(), jqs.ingest_dispatches()),
    kw={})
TORCH = types.SimpleNamespace(
    name="torch", svc=tqs.QuantileService, Window=tqs.Window,
    dev=lambda a: as_device_tensor(np.asarray(a), "cpu"),
    dtype=lambda d: getattr(torch, d),
    reset=lambda: (tsk.reset_sketch_sorts(), tqs.reset_ingest_dispatches()),
    counters=lambda: (tsk.sketch_sorts(), tqs.ingest_dispatches()),
    kw={"device": "cpu"})


def _values(dtype, n, seed):
    """n values with ties, both zeros, negative values and the dtype's
    extremes (its sentinels among them)."""
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        info = np.iinfo(np.int32)
        out = rng.integers(-50, 50, size=n)
        out[::5] = rng.integers(-10 ** 6, 10 ** 6, size=out[::5].size)
        out[1::9] = info.min
        out[4::11] = info.max
    else:
        table = np.array([-0.0, 0.0, 1.5, -1.5, 2.0, 0.0, -0.0])
        out = table[rng.integers(0, len(table), size=n)]
        out = np.where(rng.random(n) < 0.5, out, rng.normal(size=n) * 8)
        out[2::13] = np.inf
        out[6::17] = -np.inf
    return out.astype(_np_dtype(dtype))


def _tick(dtype, tick, names=NAMES, lens=LENS):
    return [_values(dtype, lens[(i + tick) % len(lens)], 1000 * tick + i)
            for i in range(len(names))]


class Recorder:
    def __init__(self, api):
        self.api = api
        self.out = []

    def __call__(self, label, fn):
        try:
            value = _bytes(fn())
        except Exception as e:            # the exception type is the answer
            value = ("raises", type(e).__name__)
        self.out.append((label, value))

    def counters(self, label):
        self.out.append((label, self.api.counters()))


def script(api, dtype, fused):
    """The scripted sequence on one package; returns its record."""
    rec = Recorder(api)
    api.reset()
    floats = dtype != "int32"
    svc = api.svc(eps=0.05, fused=fused, dtype=api.dtype(dtype), **api.kw)
    rec("empty exact", lambda: svc.exact("a", 0.5))
    for t in range(3):
        batches = _tick(dtype, t)
        if t == 1:                        # device inputs beside host ones
            batches = [api.dev(b) if i % 2 else b
                       for i, b in enumerate(batches)]
        svc.ingest_batch(NAMES, batches)
    svc.ingest_batch(["a", "b"], [np.zeros(0, _np_dtype(dtype))] * 2)
    svc.ingest("c", _values(dtype, 33, 77))
    rec.counters("after ingest")
    for name in NAMES + ["zz"]:
        rec(f"count {name}", lambda: svc.stream_count(name))
        rec(f"bound {name}", lambda: svc.rank_bound(name))
    for q in (0.01, 0.5, 1.0):
        for name in ("a", "c"):
            rec(f"approx {name} {q}", lambda: svc.approx(name, q))
            rec(f"exact {name} {q}", lambda: svc.exact(name, q))
    for name in ("a", "d"):
        rec(f"cold {name}", lambda: svc.exact(name, 0.99, warm=False))
    rec.counters("after queries")
    rec("exact_all", lambda: svc.exact_all((0.1, 0.5, 0.9)))
    rec.counters("after exact_all")
    rec("view", lambda: [svc.stream("b").n, len(svc.stream("b").chunks)]
        + list(svc.stream("b").state))

    # drop a stream; a new one takes its recycled slot
    svc.drop_stream("b")
    svc.ingest_batch(["e", "a"], [_values(dtype, 64, 5), _values(dtype, 7, 6)])
    rec("streams", lambda: svc.streams())
    rec("exact e", lambda: svc.exact("e", 0.5))
    rec("exact b", lambda: svc.exact("b", 0.5))
    rec("exact_all 2", lambda: svc.exact_all((0.5,)))
    rec("memory", lambda: svc.memory_stats())

    # grouped batches
    for i, n in enumerate((64, 33)):
        keys = np.random.default_rng(i).integers(-1, 5, size=n)
        vals = _values(dtype, n, 50 + i)
        svc.ingest_grouped("g", api.dev(vals) if i else vals, keys)
    rec("grouped", lambda: svc.grouped("g", (0.25, 0.5, 0.99), 5))
    rec("grouped count", lambda: svc.grouped_stream_count("g"))

    # staged host batches, one commit
    svc.stage("a", _values(dtype, 33, 91))
    svc.stage("f", _values(dtype, 7, 92))
    if floats:
        svc.stage("f", _values("float64", 7, 93), transform="abs_f32")
    rec("staged", lambda: svc.staged_count)
    rec("uncommitted count", lambda: svc.stream_count("f"))
    rec("exact f no commit", lambda: svc.exact("f", 0.5, commit=False))
    rec("exact f", lambda: svc.exact("f", 0.5))
    svc.commit_staged()
    rec.counters("after commit")

    # three worker buffers staged, one with a materialised table
    bufs = [svc.local_buffer() for _ in range(3)]
    for i, buf in enumerate(bufs):
        buf.stage("a", _values(dtype, 64, 200 + i))
        buf.stage(f"w{i}", _values(dtype, 33, 210 + i))
    bufs[2].ingest_batch(["c", "x"], [_values(dtype, 7, 220),
                                      _values(dtype, 64, 221)])
    svc.fold_many(bufs)
    rec.counters("after fold_many")
    rec("exact_all folded", lambda: svc.exact_all((0.05, 0.5, 0.95)))
    rec("exact x", lambda: svc.exact("x", 0.5, warm=False))

    if floats:                          # the device transform on a tick
        svc.ingest_batch(["t1", "t2"], [_values("float64", 33, 300),
                                        api.dev(_values(dtype, 7, 301))],
                         transform="abs_f32")
        rec("exact t1", lambda: svc.exact("t1", 0.9))
        rec("exact t2", lambda: svc.exact("t2", 0.1))

    # errors
    rec("bad eps", lambda: api.svc(eps=0.0, **api.kw))
    rec("bad window", lambda: api.svc(window_ticks=0, **api.kw))
    rec("mismatch", lambda: svc.ingest_batch(["a"], []))
    rec("duplicate", lambda: svc.ingest_batch(["a", "a"], [[1], [2]]))
    rec("transform", lambda: svc.ingest_batch(["a"], [[1]], transform="x"))
    rec("stage transform", lambda: svc.stage("a", [1], transform="x"))
    if floats:
        nan = np.array([1.0, np.nan], _np_dtype(dtype))
        rec("nan ingest", lambda: svc.ingest("a", nan))
        rec("nan grouped", lambda: svc.ingest_grouped("g", nan, [0, 1]))
        rec("nan stage", lambda: svc.stage("a", nan.astype(np.float32)))
    rec("grouped keys", lambda: svc.ingest_grouped("g", [1.0], [0, 1]))
    rec("empty levels", lambda: svc.exact_all(()))
    rec("empty grouped", lambda: svc.grouped("nope", (0.5,), 2))
    rec("grouped G", lambda: svc.grouped("g", (0.5,), 0))
    rec("decayed", lambda: svc.approx_decayed("a", 0.5, halflife=2.0))
    rec("window spec", lambda: api.Window())
    rec("window zero", lambda: api.Window(values=0))
    other = api.svc(eps=0.1, fused=fused, dtype=api.dtype(dtype), **api.kw)
    rec("fold mismatch", lambda: svc.fold(other))
    rec("window unwindowed", lambda: svc.windowed("a", 0.5, window=2))
    rec("window count", lambda: svc.window_count("a", window=api.Window(
        values=5)))
    rec.counters("end")
    leaves, extra = svc.snapshot()
    rec("snapshot", lambda: (leaves, extra))
    return rec.out


def windowed_script(api, dtype, fused):
    rec = Recorder(api)
    api.reset()
    svc = api.svc(eps=0.05, fused=fused, dtype=api.dtype(dtype),
                  window_ticks=6, window_subs=3, **api.kw)
    for t in range(9):
        names = NAMES if t % 3 else NAMES[:2]
        svc.ingest_batch(names, _tick(dtype, t, names))
        if t in (5, 8):
            for name in ("a", "c"):
                for w in (api.Window(ticks=2), 6, api.Window(values=40),
                          api.Window(values=10 ** 6)):
                    rec(f"win {t} {name} {w}",
                        lambda: svc.windowed(name, 0.5, window=w))
                    rec(f"count {t} {name} {w}",
                        lambda: svc.window_count(name, window=w))
                for hl in (0.5, 3.0):
                    rec(f"decayed {t} {name} {hl}",
                        lambda: svc.approx_decayed(name, 0.7, halflife=hl))
                rec(f"exact {t} {name}", lambda: svc.exact(name, 0.5))
            rec(f"exact_all {t}", lambda: svc.exact_all((0.5, 0.9)))
            rec(f"memory {t}", lambda: svc.memory_stats())
    rec("halflife", lambda: svc.approx_decayed("a", 0.5, halflife=0))
    rec("window past", lambda: svc.windowed("a", 0.5, window=9))
    svc.drop_stream("c")
    rec("memory dropped", lambda: svc.memory_stats())
    buf = svc.local_buffer()
    buf.stage("a", _values(dtype, 33, 5))
    svc.fold_many([buf])
    rec("win folded", lambda: svc.windowed("a", 0.5, window=1))
    buf.ingest("a", _values(dtype, 7, 6))
    rec("fold table", lambda: svc.fold(buf))
    rec.counters("end")
    leaves, extra = svc.snapshot()
    rec("snapshot", lambda: (leaves, extra))
    return rec.out


# The JAX service's answers do not depend on ``fused`` (its own tests pin
# that), so each JAX sequence runs once, fused apart from float32, whose
# unfused sequence runs too; the port runs every sequence both ways.
_JAX_RECORDS = {}


def _jax_record(fn, dtype, fused):
    fused = fused if dtype == "float32" else True
    key = (fn.__name__, dtype, fused)
    if key not in _JAX_RECORDS:
        with _x64(dtype):
            _JAX_RECORDS[key] = fn(JAX, dtype, fused)
    return _JAX_RECORDS[key]


def _assert_same(want, got, fused):
    assert [label for label, _ in want] == [label for label, _ in got]
    for (label, a), (_, b) in zip(want, got):
        if label == "snapshot":
            (la, ea), (lb, eb) = a, b
            assert eb.pop("fused") == fused
            ea = {k: v for k, v in ea.items() if k != "fused"}
            assert ea == eb
            assert len(la) == len(lb)
            for i, (x, y) in enumerate(zip(la, lb)):
                assert x == y, f"snapshot leaf {i}"
        else:
            assert a == b, label
