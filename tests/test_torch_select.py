"""The port's local ops, sample sketch and single-device GK Select against the
JAX package and the ``np.partition`` oracle, bit for bit.

The engine grid of ``tests/_grid.py`` (f32/bf16/int32/f64 x five
distributions x shards {1, 3, 6}) runs every entry point of the slice:
``gk_select`` in its three modes, ``gk_select_multi`` (fused and not),
``exact_quantile(_rank)``, ``full_sort_quantile`` and ``approx_quantile``.
The JAX side runs on its jnp backend (bit-identical to the Pallas kernels,
see ``tests/test_dispatch.py``).  Tolerance is zero: raw bytes compare.
"""
import contextlib
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402

from _grid import (DTYPES, DISTRIBUTIONS, SHARD_COUNTS, QS,   # noqa: E402
                   _np_dtype, make_case, oracle_kth, target_rank)
import repro.core as J                                        # noqa: E402
from repro.core import local_ops as jlo                       # noqa: E402
from repro.core import sketch as jsk                          # noqa: E402
import repro_torch.core as T                                  # noqa: E402
from repro_torch.core import local_ops as tlo                 # noqa: E402
from repro_torch.core import sketch as tsk                    # noqa: E402

N = 720                         # divisible by every shard count and by 8


def _x64(dtype):
    return jax.enable_x64(True) if dtype == "float64" else contextlib.nullcontext()


def tb(t):
    """Raw bytes of a torch tensor (shape included)."""
    view = {2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()]
    return tuple(t.shape), t.contiguous().view(view).numpy().tobytes()


def jb(a):
    a = np.asarray(a)
    return a.shape, a.tobytes()


def _t(a):
    return T.as_device_tensor(np.asarray(a), "cpu")


def _signed_zero_case(dtype, n, seed=0):
    rng = np.random.default_rng(seed)
    table = np.array([-0.0, 0.0, -1.0, 1.0, 2.0, 0.0, -0.0])
    return table[rng.integers(0, len(table), size=n)].astype(_np_dtype(dtype))


# ---------------------------------------------------------------------------
# local ops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_local_ops_match_jax(dtype):
    xs = [make_case("uniform", dtype, 600, seed=3),
          make_case("ties", dtype, 600, seed=3)]
    if dtype != "int32":
        xs.append(_signed_zero_case(dtype, 600))
    with _x64(dtype):
        for x in xs:
            jx, tx = jnp.asarray(x), _t(x)
            for pivot in (x[0], x[300], x.max(), x.min()):
                jp, tp = jnp.asarray(pivot), _t(np.asarray(pivot).reshape(1))[0]
                assert tb(tlo.count3(tx, tp)) == jb(jlo.count3(jx, jp))
                for cap in (1, 25, 600):
                    assert tb(tlo.extract_below(tx, tp, cap)) == \
                        jb(jlo.extract_below(jx, jp, cap))
                    assert tb(tlo.extract_above(tx, tp, cap)) == \
                        jb(jlo.extract_above(jx, jp, cap))
                got = tlo.fused_count_extract(tx, tp, 25)
                want = jlo.fused_count_extract(jx, jp, 25)
                assert [tb(g) for g in got] == [jb(w) for w in want]
            for k in (1, 17, 300, 600, 700):
                assert tb(tlo.kth_smallest(tx, torch.tensor(k), 0)) == \
                    jb(jlo.kth_smallest(jx, jnp.int32(k), 0))
                assert tb(tlo.kth_largest(tx, torch.tensor(k), 0)) == \
                    jb(jlo.kth_largest(jx, jnp.int32(k), 0))
            padded = tlo.pad_with_high_sentinel(tx.reshape(3, 200), 64)
            assert tb(padded) == jb(jlo.pad_with_high_sentinel(
                jx.reshape(3, 200), 64))
            assert tb(tlo.pad_with_high_sentinel(tx, 8)) == tb(tx)


@pytest.mark.parametrize("dtype", DTYPES)
def test_resolve_matches_jax(dtype):
    x = make_case("zipf", dtype, 900, seed=5).reshape(3, 300)
    with _x64(dtype):
        jx, tx = jnp.asarray(x), _t(x)
        for pi in (0, 450, 899):
            pivot = x.reshape(-1)[pi]
            jp, tp = jnp.asarray(pivot), _t(np.asarray(pivot).reshape(1))[0]
            cap = 40
            jc, jbl, jab = jax.vmap(
                lambda s: jlo.fused_count_extract(s, jp, cap))(jx)
            tc, tbl, tab = tlo.fused_count_extract(tx, tp, cap)
            jc, tc = jc.sum(0), tc.sum(0)
            for k in (1, 299, 450, 900):
                want = jlo.resolve(jp, jnp.int32(k), jc[0], jc[1], jbl, jab, cap)
                got = tlo.resolve(tp, torch.tensor(k), tc[0], tc[1], tbl, tab,
                                  cap)
                assert tb(got) == jb(want), (dtype, pi, k)


def test_rank_rules_and_caps_match_jax():
    for n in (1, 7, 720, 10 ** 9, 2 ** 31 - 1):
        for q in (1e-9, 0.001, 0.1, 1 / 3, 0.5, 0.999, 1.0):
            assert tlo.target_rank(n, q) == jlo.target_rank(n, q)
            assert tlo.exact_target_rank(n, q) == jlo.exact_target_rank(n, q)
        for eps in (1e-4, 0.01, 0.3):
            for p in (1, 6, 120):
                n_i = max(1, n // p)
                assert tlo.candidate_cap(n, eps, n_i) == \
                    jlo.candidate_cap(n, eps, n_i)
                assert tsk.sample_sketch_params(n, n_i, eps, p) == \
                    jsk.sample_sketch_params(n, n_i, eps, p)
    with pytest.raises(ValueError):
        tlo.exact_target_rank(5, 0.0)
    with pytest.raises(ValueError):
        tsk.sample_sketch_params(10, 10, 1.0, 1)


def test_reject_nans():
    with pytest.raises(ValueError, match="NaN"):
        tlo.reject_nans(torch.tensor([1.0, float("nan")]), "here")
    tlo.reject_nans(torch.tensor([1, 2], dtype=torch.int32), "here")
    parts = torch.tensor([[1.0, float("nan")], [2.0, 3.0]])
    for fn in (lambda: T.gk_select(parts, 0.5),
               lambda: T.gk_select_multi(parts, (0.5,))):
        with pytest.raises(ValueError, match="NaN"):
            fn()


# ---------------------------------------------------------------------------
# sample sketch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_sample_sketch_matches_jax(dtype):
    cases = [make_case(d, dtype, N, seed=7) for d in DISTRIBUTIONS]
    if dtype != "int32":
        cases.append(_signed_zero_case(dtype, N, seed=7))
    with _x64(dtype):
        for x in cases:
            parts = x.reshape(6, -1)
            m, s = jsk.sample_sketch_params(N, 120, 0.03, 6)
            jv, jw = jax.vmap(
                lambda r: jsk.local_sample_sketch(r, m, s))(jnp.asarray(parts))
            tv, tw = tsk.local_sample_sketch(_t(parts), m, s)
            assert tb(tv) == jb(jv) and tb(tw) == jb(jw)
            ks = [1, 100, 360, 719, 720]
            want = jax.vmap(lambda k: jsk.query_merged_sketch(
                jv.ravel(), jw.ravel(), k, 6, m))(jnp.array(ks, jnp.int32))
            got = tsk.query_merged_sketch(tv.reshape(-1), tw.reshape(-1),
                                          torch.tensor(ks), 6, m)
            assert tb(got) == jb(want)
            assert tb(tsk.query_merged_sketch(
                tv.reshape(-1), tw.reshape(-1), 360, 6, m)) == jb(want[2])


def test_sketch_sort_counter():
    tsk.reset_sketch_sorts()
    tsk.record_sketch_sort()
    tsk.record_sketch_sort(2)
    assert tsk.sketch_sorts() == 3
    tsk.reset_sketch_sorts()
    assert tsk.sketch_sorts() == 0


# ---------------------------------------------------------------------------
# the slice as a whole, over the engine grid
# ---------------------------------------------------------------------------


def _cells():
    for dtype in DTYPES:
        for dist in DISTRIBUTIONS:
            yield dtype, dist


@pytest.mark.parametrize("dtype,dist", list(_cells()))
@pytest.mark.parametrize("parts", SHARD_COUNTS)
def test_gk_select_grid(dtype, dist, parts):
    x = make_case(dist, dtype, N)
    tx = _t(x).reshape(parts, -1)
    want = [jb(oracle_kth(x, target_rank(N, q)))[1] for q in QS]
    for i, q in enumerate(QS):
        for kw in ({}, {"speculative": True}, {"block_select": True}):
            assert tb(T.gk_select(tx, q, **kw))[1] == want[i], (q, kw)
        assert tb(T.full_sort_quantile(tx, q))[1] == want[i]
    for block in (False, True):
        got = T.gk_select_multi(tx, QS, block_select=block)
        assert tb(got)[1] == b"".join(want)

    with _x64(dtype):
        jx = jnp.asarray(x).reshape(parts, -1)
        assert tb(T.gk_select_multi(tx, QS, block_select=True)) == \
            jb(J.gk_select_multi(jx, QS, block_select=True, backend="jnp"))
        assert tb(T.gk_select(tx, 0.5, block_select=True)) == \
            jb(J.gk_select(jx, 0.5, block_select=True, backend="jnp"))
        assert tb(T.approx_quantile(tx, 0.5)) == jb(J.approx_quantile(jx, 0.5))
        assert tb(T.full_sort_quantile(tx, 0.5)) == \
            jb(J.full_sort_quantile(jx, 0.5))
        if parts == 1:
            assert tb(T.exact_quantile(x, 0.5, device="cpu")) == \
                jb(J.exact_quantile(jnp.asarray(x), 0.5))
            k = target_rank(N, 0.25)
            assert tb(T.exact_quantile_rank(x, k, device="cpu")) == \
                jb(J.exact_quantile_rank(jnp.asarray(x), k))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
def test_signed_zeros_match_jax(dtype):
    """Answers that are zeros keep JAX's sign in every mode."""
    x = _signed_zero_case(dtype, 900, seed=11)
    tx = _t(x).reshape(3, -1)
    qs = (0.05, 0.2, 0.3, 0.45, 0.5, 0.55, 0.6)
    with _x64(dtype):
        jx = jnp.asarray(x).reshape(3, -1)
        want = jb(J.gk_select_multi(jx, qs, block_select=True, backend="jnp"))
        for block in (False, True):
            assert tb(T.gk_select_multi(tx, qs, block_select=block)) == want
        for q in (0.3, 0.5):
            want = jb(J.gk_select(jx, q))
            for kw in ({}, {"speculative": True}, {"block_select": True}):
                assert tb(T.gk_select(tx, q, **kw)) == want, (q, kw)
            assert tb(T.full_sort_quantile(tx, q)) == \
                jb(J.full_sort_quantile(jx, q))


def test_rank_addressing_and_eps_do_not_change_answers():
    rng = np.random.default_rng(13)
    x = rng.normal(size=(4, 1000)).astype(np.float32)
    tx = torch.from_numpy(x)
    srt = np.sort(x.ravel())
    for k in (1, 2, 1999, 4000):
        assert float(T.gk_select(tx, None, k=k)) == srt[k - 1]
        assert float(T.exact_quantile_rank(x.ravel(), k, device="cpu")) == \
            srt[k - 1]
    for eps in (1e-3, 0.01, 0.2):
        for q in (0.01, 0.5, 0.99):
            want = srt[math.ceil(q * x.size) - 1]
            for kw in ({}, {"speculative": True}, {"block_select": True}):
                assert float(T.gk_select(tx, q, eps=eps, **kw)) == want
    with pytest.raises(ValueError):
        T.exact_quantile(x.ravel()[:-1], 0.5, device="cpu")
    with pytest.raises(ValueError):
        T.exact_quantile_rank(x.ravel(), 0, device="cpu")
