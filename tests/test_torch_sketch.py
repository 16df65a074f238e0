"""The port's streaming sketch (``SketchState``) and host ``GKSketch``
against the JAX package, bit for bit.

For each dtype of ``tests/_grid.py`` the same numpy streams (ties, mixed
-0.0/+0.0, the dtype's high sentinel, ragged valid counts including 0) go
through ``repro.core.sketch`` and ``repro_torch.core.sketch``: every leaf of
every state and every answer must have the same bytes.  Tolerance is zero.

The cases are split over this file and ``test_torch_sketch_merge.py``,
``test_torch_sketch_query.py`` and ``test_torch_sketch_state.py``, so that
xdist's ``--dist loadfile`` can run them on several workers; those files
import their helpers from here.
"""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402

from _grid import DTYPES, _np_dtype                           # noqa: E402
from repro.core import sketch as J                            # noqa: E402
from repro_torch.core import sketch as T                      # noqa: E402
from repro_torch.core.select import as_device_tensor          # noqa: E402

BUDGET = 32


def _x64(dtype):
    return (jax.enable_x64(True) if dtype == "float64"
            else contextlib.nullcontext())


def tb(t):
    view = {2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()]
    return tuple(t.shape), t.contiguous().view(view).numpy().tobytes()


def jb(a):
    a = np.asarray(a)
    return a.shape, a.tobytes()


def _t(a):
    return as_device_tensor(np.asarray(a), "cpu")


def assert_state(js, ts):
    for name, a, b in zip(J.SketchState._fields, js, ts):
        assert jb(a) == tb(b), name


def _stream(dtype, n, seed):
    """n values drawn from a small table: ties, both zeros, the extremes
    (the high sentinel included) and a few spread values."""
    rng = np.random.default_rng(seed)
    dt = _np_dtype(dtype)
    if dtype == "int32":
        info = np.iinfo(np.int32)
        table = np.array([0, 0, 1, -1, 5, 5, 5, info.max, info.min, 7, 100,
                          -100], np.int64)
        spread = rng.integers(-1000, 1000, size=n)
    else:
        table = np.array([-0.0, 0.0, 0.0, -0.0, 1.5, 1.5, -2.0, np.inf,
                          -np.inf, 3.0, 0.25, -0.0])
        spread = rng.normal(size=n) * 10
    pick = rng.integers(0, len(table), size=n)
    out = np.where(rng.random(n) < 0.6, table[pick], spread)
    return out.astype(dt)


def _hi(dtype):
    dt = _np_dtype(dtype)
    return (np.iinfo(dt).max if dtype == "int32" else dt.type(np.inf))


def _padded(dtype, lengths, L, seed):
    m = np.full((len(lengths), L), _hi(dtype), dtype=_np_dtype(dtype))
    for i, n in enumerate(lengths):
        m[i, :n] = _stream(dtype, n, seed + i)
    return m


def _jax_stacked(dtype, S, rounds, seed):
    """A stacked JAX state after ``rounds`` ragged batched updates, and the
    port's after the same updates (each round compared)."""
    jst = J.sketch_init_stack(S, BUDGET, jnp.dtype(_np_dtype(dtype)))
    tst = T.sketch_init_stack(S, BUDGET, _t(np.zeros(1, _np_dtype(dtype))).dtype,
                              device="cpu")
    assert_state(jst, tst)
    rng = np.random.default_rng(seed)
    for r in range(rounds):
        L = (90, 24)[r % 2]
        lengths = rng.integers(0, L + 1, size=S)
        lengths[r % S] = 0
        lengths[(r + 1) % S] = L
        m = _padded(dtype, lengths, L, seed * 100 + r)
        jst = J.sketch_update_batch(jst, jnp.asarray(m),
                                    jnp.asarray(lengths, jnp.int32))
        tst = T.sketch_update_batch(tst, _t(m), _t(lengths.astype(np.int32)))
        assert_state(jst, tst)
    return jst, tst


@pytest.mark.parametrize("dtype", DTYPES)
def test_sketch_update_matches_jax(dtype):
    with _x64(dtype):
        jd = jnp.dtype(_np_dtype(dtype))
        js = J.sketch_init(BUDGET, jd)
        ts = T.sketch_init(BUDGET, _t(np.zeros(1, _np_dtype(dtype))).dtype,
                           device="cpu")
        assert_state(js, ts)
        for i, n in enumerate((1, 0, 5, 33, 200, 0, 64)):
            batch = _stream(dtype, n, i)
            js = J.sketch_update(js, jnp.asarray(batch))
            ts = T.sketch_update(ts, _t(batch))
            assert_state(js, ts)


@pytest.mark.parametrize("dtype", DTYPES)
def test_sketch_update_padded_matches_jax(dtype):
    """One state, a sentinel-padded batch and a valid count: 0, part and
    all of the batch."""
    with _x64(dtype):
        jd = jnp.dtype(_np_dtype(dtype))
        js = J.sketch_init(BUDGET, jd)
        ts = T.sketch_init(BUDGET, _t(np.zeros(1, _np_dtype(dtype))).dtype,
                           device="cpu")
        for i, (L, nv) in enumerate(((10, 0), (10, 10), (50, 17), (80, 80),
                                     (5, 0), (100, 99))):
            row = _padded(dtype, [nv], L, i)[0]
            js = J.sketch_update_padded(js, jnp.asarray(row), nv)
            ts = T.sketch_update_padded(ts, _t(row), nv)
            assert_state(js, ts)


def test_sketch_budget_init_and_stack():
    for eps in (0.5, 0.01, 1e-3, 1e-4, 1e-6):
        assert T.sketch_budget(eps) == J.sketch_budget(eps)
    for bad in (0.0, 1.0, -1.0):
        with pytest.raises(ValueError):
            T.sketch_budget(bad)
    st = T.sketch_init_stack(3, 8, torch.int32, device="cpu")
    assert st.values.shape == (3, 8) and st.n.shape == (3,)
    assert int(st.values.max()) == np.iinfo(np.int32).max
    rows = T.sketch_unstack(st)
    assert len(rows) == 3
    again = T.sketch_stack(rows)
    for a, b in zip(st, again):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        T.sketch_stack([])
    with pytest.raises(ValueError):
        T.sketch_merge_many([])
