"""The port's sketch queries (rank, decayed) and the host ``GKSketch``
against the JAX package's, bit for bit (inputs, helpers and tolerances:
``test_torch_sketch.py``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402
from _grid import DTYPES                                      # noqa: E402
from repro.core import sketch as J                            # noqa: E402
from repro_torch.core import sketch as T                      # noqa: E402

from test_torch_sketch import (_jax_stacked, _t, _x64, jb, tb)  # noqa: E402


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
