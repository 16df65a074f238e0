"""The port's streaming sketch (``SketchState``) and host ``GKSketch``
against the JAX package, bit for bit.

For each dtype of ``tests/_grid.py`` the same numpy streams (ties, mixed
-0.0/+0.0, the dtype's high sentinel, ragged valid counts including 0) go
through ``repro.core.sketch`` and ``repro_torch.core.sketch``: every leaf of
every state and every answer must have the same bytes.  Tolerance is zero.
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


@pytest.mark.parametrize("dtype", DTYPES)
def test_sketch_update_batch_matches_jax(dtype):
    with _x64(dtype):
        _jax_stacked(dtype, 5, 6, seed=3)


@pytest.mark.parametrize("dtype", DTYPES)
def test_sketch_merges_match_jax(dtype):
    with _x64(dtype):
        ja, ta = _jax_stacked(dtype, 4, 4, seed=5)
        jb_, tb_ = _jax_stacked(dtype, 4, 3, seed=6)
        jc, tc = _jax_stacked(dtype, 4, 2, seed=7)
        assert_state(J.sketch_merge_batch(ja, jb_),
                     T.sketch_merge_batch(ta, tb_))
        for k in (1, 2, 3):
            assert_state(J.sketch_merge_many([ja, jb_, jc][:k]),
                         T.sketch_merge_many([ta, tb_, tc][:k]))
        # one-row merges, an empty side included (row 0 of a fresh table)
        empty_j = J.sketch_unstack(J.sketch_init_stack(
            1, BUDGET, ja.values.dtype))[0]
        empty_t = T.sketch_unstack(T.sketch_init_stack(
            1, BUDGET, ta.values.dtype, device="cpu"))[0]
        rows_j, rows_t = J.sketch_unstack(ja), T.sketch_unstack(ta)
        for a_j, a_t in zip(rows_j, rows_t):
            assert_state(a_j, a_t)
            assert_state(J.sketch_merge(a_j, rows_j[1]),
                         T.sketch_merge(a_t, rows_t[1]))
            assert_state(J.sketch_merge(empty_j, a_j),
                         T.sketch_merge(empty_t, a_t))
        for k in (1, 2, 3, 4):
            assert_state(J.sketch_merge_rows(J.sketch_stack(rows_j[:k])),
                         T.sketch_merge_rows(T.sketch_stack(rows_t[:k])))
        with pytest.raises(ValueError):
            T.sketch_merge(rows_t[0], T.sketch_init(BUDGET // 2,
                                                    ta.values.dtype,
                                                    device="cpu"))


@pytest.mark.parametrize("dtype", DTYPES)
def test_sketch_queries_match_jax(dtype):
    with _x64(dtype):
        js, ts = _jax_stacked(dtype, 4, 5, seed=11)
        n_max = int(np.max(np.asarray(js.n)))
        ks = np.array([[1, 2, n_max // 3, n_max, n_max + 5, 0]] * 4, np.int32)
        assert jb(J.sketch_query_rank_batch(js, ks)) == tb(
            T.sketch_query_rank_batch(ts, _t(ks)))
        assert jb(J.sketch_rank_bound_batch(js)) == tb(
            T.sketch_rank_bound_batch(ts))
        for rj, rt in zip(J.sketch_unstack(js), T.sketch_unstack(ts)):
            assert jb(J.sketch_rank_bound(rj)) == tb(T.sketch_rank_bound(rt))
            for k in ks[0]:
                assert jb(J.sketch_query_rank(rj, int(k))) == tb(
                    T.sketch_query_rank(rt, int(k)))


@pytest.mark.parametrize("dtype", DTYPES)
def test_sketch_query_decayed_matches_jax(dtype):
    with _x64(dtype):
        js, ts = _jax_stacked(dtype, 5, 5, seed=13)
        ages = np.array([9, 6, 3, 1, 0], np.float32)
        for halflife in (0.7, 2.0, 5.0):
            factors = np.exp2(-ages / halflife)
            for q in (0.01, 0.3, 0.5, 0.9, 1.0):
                want = jax.jit(J.sketch_query_decayed)(
                    js, jnp.asarray(factors), jnp.float32(q))
                got = T.sketch_query_decayed(ts, _t(factors), q)
                assert jb(want) == tb(got), (halflife, q)


@pytest.mark.parametrize("n", [1, 2, 15, 16, 17, 255, 256, 257, 4097, 9000])
def test_blocked_cumsum_is_jax_cumsum(n):
    """``jnp.cumsum`` of float32 is XLA's blocked scan; the port adds in the
    same order."""
    rng = np.random.default_rng(n)
    w = (rng.integers(0, 60, size=n) * np.float32(0.70710677)).astype(
        np.float32)
    assert jb(jax.jit(jnp.cumsum)(w)) == tb(T.blocked_cumsum(_t(w)))


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


@pytest.mark.parametrize("dtype", DTYPES)
def test_state_converter_round_trips_a_jax_state(dtype):
    with _x64(dtype):
        js, _ = _jax_stacked(dtype, 3, 3, seed=17)
        leaves = [np.asarray(a) for a in js]
        if dtype == "bfloat16":
            leaves[0] = leaves[0].view(np.uint16)    # checkpoint storage
        ts = T.sketch_state_from_numpy(*leaves, device="cpu")
        assert_state(js, ts)
        back = T.sketch_state_to_numpy(ts)
        for a, b in zip(leaves, back):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        # an ml_dtypes bfloat16 array converts as well
        ts2 = T.sketch_state_from_numpy(*[np.asarray(a) for a in js],
                                        device="cpu")
        assert_state(js, ts2)


def _gk_equal(a, b):
    assert a.n == b.n and a.size == b.size
    assert a.v.tobytes() == b.v.tobytes()
    assert a.g.tobytes() == b.g.tobytes()
    assert a.delta.tobytes() == b.delta.tobytes()


@pytest.mark.parametrize("adaptive", [False, True])
def test_gk_sketch_matches_jax(adaptive):
    rng = np.random.default_rng(21)
    kw = dict(head_size=64, compress_threshold=40, adaptive_head=adaptive)
    js = [J.GKSketch(eps, **kw) for eps in (0.02, 0.05, 0.02)]
    ts = [T.GKSketch(eps, **kw) for eps in (0.02, 0.05, 0.02)]
    for i, (a, b) in enumerate(zip(js, ts)):
        data = np.round(rng.normal(size=500 + 37 * i), 1)
        for x in data[:50]:
            a.insert(x)
            b.insert(x)
        a.insert_batch(data[50:])
        b.insert_batch(data[50:])
        for q in (0.01, 0.5, 0.99):
            assert a.query(q) == b.query(q)
        _gk_equal(a, b)
        assert (a.flush_count, a.compress_count) == (b.flush_count,
                                                     b.compress_count)
    _gk_equal(js[0].merge(js[1]), ts[0].merge(ts[1]))
    _gk_equal(J.merge_fold_left(js), T.merge_fold_left(ts))
    _gk_equal(J.merge_tree(js), T.merge_tree(ts))
    with pytest.raises(ValueError):
        T.GKSketch(0.1).query_rank(1)
