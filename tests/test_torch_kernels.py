"""The port's fused count+extract layer against the JAX package, bit for bit.

Plain versions (``repro_torch.kernels.ref`` through ``dispatch``) vs
``repro.kernels.dispatch.run_fused_select(_multi)`` on the jnp backend, plus
one Pallas interpret-mode case each; the order-preserving keys vs
``to_sortable_u32``; dispatch, pass counting and the kernel wrappers' device
checks.  Tolerance is zero: outputs are compared as raw bytes, so a zero's
sign counts.  The kernels themselves are held against the plain versions on
the card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402

from _grid import _np_dtype                                   # noqa: E402
from repro.kernels import dispatch as jdispatch               # noqa: E402
from repro.kernels import ops as jops                         # noqa: E402
from repro_torch.core import as_device_tensor                 # noqa: E402
from repro_torch.kernels import dispatch, ops, ref            # noqa: E402
from repro_torch.kernels import fused_select as fs            # noqa: E402

DTYPES = ("float32", "bfloat16", "int32", "float64")
N = 1001                        # not a multiple of any vector width


def _x64(dtype):
    return jax.enable_x64(True) if dtype == "float64" else contextlib.nullcontext()


def tbits(t):
    view = {2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()]
    return tuple(t.shape), t.contiguous().view(view).numpy().tobytes()


def jbits(a):
    a = np.asarray(a)
    return a.shape, a.tobytes()


def _data(dtype, n=N, seed=0):
    """Normal values with both zeros and both sentinels mixed in."""
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        x = rng.integers(-1000, 1000, size=n).astype(np.int32)
        x[::97] = np.iinfo(np.int32).min
        x[5::89] = np.iinfo(np.int32).max
        return x
    x = rng.normal(size=n).astype(np.float64)
    x[::13] = 0.0
    x[3::17] = -0.0
    x[::97] = -np.inf
    x[5::89] = np.inf
    return x.astype(_np_dtype(dtype))


def _pivots(x):
    """Pivots at and beyond the extremes, inside, and both zeros."""
    srt = np.sort(x.astype(np.float64))
    picks = [srt[len(srt) // 2], srt[len(srt) // 10], srt[0], srt[-1],
             srt[len(srt) - 3]]
    if x.dtype.kind == "i":
        picks += [-1001, 1001]
    else:
        picks += [-1e30, 1e30, 0.0, -0.0, 1.0, -1.0]
    return np.array(picks).astype(x.dtype)


def _jax_fused(x, pivot, cap, backend="jnp"):
    out, _ = jdispatch.run_fused_select(jnp.asarray(x), jnp.asarray(pivot),
                                        cap, backend=backend)
    return out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cap", [1, 37, N])
def test_fused_select_plain_matches_jax(dtype, cap):
    x = _data(dtype)
    xt = as_device_tensor(x, "cpu").unsqueeze(0)
    with _x64(dtype):
        for pivot in _pivots(x):
            want = _jax_fused(x, pivot, cap)
            (got, route) = dispatch.run_fused_select(
                xt, as_device_tensor(pivot.reshape(1), "cpu")[0], cap)
            assert route == dispatch.PLAIN
            for g, w in zip(got, want):
                assert tbits(g[0]) == jbits(w), (dtype, cap, pivot)


@pytest.mark.parametrize("dtype", DTYPES)
def test_all_equal_and_tiny_shards(dtype):
    value = 7 if dtype == "int32" else 3.25
    cases = [(np.full(N, value).astype(_np_dtype(dtype)), 37),
             (_data(dtype, n=7, seed=3), 7)]
    with _x64(dtype):
        for x, cap in cases:
            xt = as_device_tensor(x, "cpu")
            for pivot in _pivots(x):
                want = _jax_fused(x, pivot, cap)
                got = ops.fused_count_extract(
                    xt, as_device_tensor(pivot.reshape(1), "cpu")[0], cap)
                for g, w in zip(got, want):
                    assert tbits(g) == jbits(w), (dtype, cap, pivot)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cap", [37, N])
def test_fused_select_multi_plain_matches_jax(dtype, cap):
    x = _data(dtype, seed=1)
    pv = _pivots(x)
    pv = np.concatenate([pv, pv[:3]])          # duplicate pivots
    with _x64(dtype):
        (want, _) = jdispatch.run_fused_select_multi(
            jnp.asarray(x), jnp.asarray(pv), cap, backend="jnp")
    (got, route) = dispatch.run_fused_select_multi(
        as_device_tensor(x, "cpu").unsqueeze(0), as_device_tensor(pv, "cpu"),
        cap)
    assert route == dispatch.PLAIN
    for g, w in zip(got, want):
        assert tbits(g[0]) == jbits(w), (dtype, cap)


def test_interpret_kernels_match_plain():
    """The Pallas kernels themselves (interpret mode) against the port."""
    x = _data("float32", seed=2)
    pv = _pivots(x)[[0, 1, 8, 9]]
    want = _jax_fused(x, pv[2], 37, backend="interpret")
    got = ops.fused_count_extract(as_device_tensor(x, "cpu"),
                                  torch.tensor(pv[2]), 37)
    for g, w in zip(got, want):
        assert tbits(g) == jbits(w)
    (want, _) = jdispatch.run_fused_select_multi(
        jnp.asarray(x), jnp.asarray(pv), 37, backend="interpret")
    got = ops.fused_count_extract_multi(as_device_tensor(x, "cpu"),
                                        torch.from_numpy(pv), 37)
    for g, w in zip(got, want):
        assert tbits(g) == jbits(w)


def test_batched_shards_match_per_shard():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(3, 500)).astype(np.float32))
    pivots = x[0, :4].clone()
    counts, below, above = ops.fused_count_extract_multi(x, pivots, 25)
    assert counts.shape == (3, 4, 3) and below.shape == (3, 4, 25)
    for p in range(3):
        for q in range(4):
            c, b, a = ref.fused_select_ref(x[p], pivots[q], 25)
            assert torch.equal(counts[p, q], c)
            assert torch.equal(below[p, q], b) and torch.equal(above[p, q], a)


@pytest.mark.parametrize("dtype", DTYPES)
def test_sortable_keys(dtype):
    x = _data(dtype, seed=5)
    xt = as_device_tensor(x, "cpu")
    u = ops.to_sortable(xt)
    assert u.element_size() == xt.element_size()
    assert tbits(ops.from_sortable(u, xt.dtype)) == tbits(xt)
    if dtype in ("float32", "int32"):
        assert u.numpy().tobytes() == np.asarray(
            jops.to_sortable_u32(jnp.asarray(x))).tobytes()
    if dtype == "bfloat16":        # the top half of JAX's 32-bit key
        j = np.asarray(jops.to_sortable_u32(jnp.asarray(x)))
        assert np.array_equal(u.numpy().astype(np.uint32), j >> 16)
    # unsigned key order is the total order: -0.0 right below +0.0
    keys = ref.total_order_key(xt).to(torch.int64)
    wide = x.astype(np.float64)
    order = np.lexsort((~np.signbit(wide), wide))
    assert bool((keys[torch.from_numpy(order)].diff() >= 0).all())
    if dtype != "int32":
        z = torch.tensor([-0.0, 0.0]).to(xt.dtype)
        kz = ref.total_order_key(z)
        assert int(kz[0]) < int(kz[1])


def test_pass_counter_counts_plain_passes():
    x = torch.randn(3, 300)
    keys = torch.randint(0, 2, (3, 300), dtype=torch.int32)
    cases = ((lambda: ops.fused_count_extract(x, x[0, 0], 10), 3),
             (lambda: ops.fused_count_extract_multi(x, x[0, :4], 10), 12),
             (lambda: ops.count3(x, x[0, 0]), 1),
             (lambda: ops.band_count(x, -1.0, 1.0), 1),
             (lambda: ops.byte_histogram(ops.to_sortable_u32(x), 0, 0,
                                         shift=24), 1),
             (lambda: ops.radix_select_kth(x, 5), ops.RADIX_PASSES + 1),
             (lambda: ops.radix_select_kth_bitwise(x, 5), 33),
             (lambda: ops.segmented_count_extract(x, keys, x[0, :6].reshape(
                 2, 3), 10), 18))
    for call, passes in cases:
        ops.reset_hbm_passes()
        call()
        assert ops.hbm_passes() == passes
    assert fs.launches_for(5) == 1 and fs.launches_for(9) == 2


def test_dispatch_routes_by_device():
    assert dispatch.route(torch.zeros(2)) == dispatch.PLAIN
    with pytest.raises(ValueError):
        dispatch.route(torch.zeros(2, device="meta"))
    with pytest.raises(ValueError):       # wrappers take CUDA tensors only
        fs.fused_select(torch.zeros(2, 8), torch.tensor(0.0), 2)
    with pytest.raises(ValueError):
        ref.block_topk_ref(torch.zeros(8), torch.tensor(0.0), 9, True)
    x = torch.randn(64)
    v, k = x.reshape(2, 32), torch.zeros(2, 32, dtype=torch.int32)
    for run, args in ((dispatch.run_partition_count, (x, 0.0)),
                      (dispatch.run_band_count, (x, -1.0, 1.0)),
                      (dispatch.run_byte_histogram,
                       (ops.to_sortable_u32(x), 0, 0, 24)),
                      (dispatch.run_radix_walk, (x, 3)),
                      (dispatch.run_bisect, (x, 3)),
                      (dispatch.run_segmented_select,
                       (v, k, torch.zeros(1, 1), 4))):
        assert run(*args)[1] == dispatch.PLAIN


def test_make_fused_fns_are_the_seams():
    x = torch.randn(2, 64)
    c1 = ops.make_fused_fn()(x, x[0, 3], 5)
    c2 = ops.fused_count_extract(x, x[0, 3], 5)
    assert all(torch.equal(a, b) for a, b in zip(c1, c2))
    m1 = ops.make_fused_multi_fn()(x, x[0, :2], 5)
    m2 = ops.fused_count_extract_multi(x, x[0, :2], 5)
    assert all(torch.equal(a, b) for a, b in zip(m1, m2))
    assert torch.equal(ops.make_count3_fn()(x, x[0, 3]), ops.count3(x, x[0, 3]))
    keys = torch.randint(-1, 3, (2, 64), dtype=torch.int32)
    pivots = x[0, :4].reshape(2, 2)
    s1 = ops.make_segmented_fn()(x, keys, pivots, 5)
    s2 = ops.segmented_count_extract(x, keys, pivots, 5)
    assert all(torch.equal(a, b) for a, b in zip(s1, s2))
    flat = ops.segmented_count_extract(x[1], keys[1], pivots, 5)
    assert all(torch.equal(a, b[1]) for a, b in zip(flat, s2))

# ---------------------------------------------------------------------------
# counting, histogram, segmented and radix entry points (plain) vs JAX
# ---------------------------------------------------------------------------


def _scalar(a):
    return as_device_tensor(np.asarray(a).reshape(1), "cpu")[0]


@pytest.mark.parametrize("dtype", DTYPES)
def test_count3_and_band_count_match_jax(dtype):
    x = _data(dtype, seed=7)
    pv = _pivots(x)
    xt = as_device_tensor(x, "cpu")
    with _x64(dtype):
        jx = jnp.asarray(x)
        for i, p in enumerate(pv):
            q = pv[len(pv) - 1 - i]
            assert tbits(ops.count3(xt, _scalar(p))) == jbits(
                jops.count3(jx, jnp.asarray(p), backend="jnp")), (dtype, p)
            assert tbits(ops.band_count(xt, _scalar(p), _scalar(q))) == jbits(
                jops.band_count(jx, jnp.asarray(p), jnp.asarray(q),
                                backend="jnp")), (dtype, p, q)


@pytest.mark.parametrize("dtype", ("float32", "bfloat16", "int32"))
def test_byte_histogram_and_radix_selects_match_jax(dtype):
    x = _data(dtype, seed=8)                    # both zeros, both sentinels
    xt = as_device_tensor(x, "cpu")
    ju = jops.to_sortable_u32(jnp.asarray(x))
    u = ops.to_sortable_u32(xt)
    assert u.dtype == torch.uint32
    assert u.numpy().tobytes() == np.asarray(ju).tobytes()
    back = ops.from_sortable_u32(u, xt.dtype)
    assert tbits(back) == jbits(jops.from_sortable_u32(ju, jnp.asarray(x).dtype))
    top = int(np.asarray(ju)[N // 3])
    for prefix, mask, shift in ((0, 0, 24), (top & 0xFF000000, 0xFF000000, 16),
                                (top & 0xFFFF0000, 0xFFFF0000, 8),
                                (top & 0xFFFFFF00, 0xFFFFFF00, 0)):
        want = jops.byte_histogram(ju, prefix, mask, shift=shift,
                                   backend="jnp")
        assert tbits(ops.byte_histogram(u, prefix, mask, shift=shift)) == \
            jbits(want), (prefix, mask, shift)
    jx = jnp.asarray(x)
    for k in (-1, 0, 1, 2, N // 2, N - 1, N, N + 1):
        assert tbits(ops.radix_select_kth(xt, k)) == jbits(
            jops.radix_select_kth(jx, k, backend="jnp")), k
        assert tbits(ops.radix_select_kth_bitwise(xt, k)) == jbits(
            jops.radix_select_kth_bitwise(jx, k, backend="jnp")), k


def test_sortable_u32_refuses_float64():
    x = torch.zeros(3, dtype=torch.float64)
    for call in (ops.to_sortable_u32, lambda t: ops.radix_select_kth(t, 1),
                 lambda t: ops.radix_select_kth_bitwise(t, 1)):
        with pytest.raises(TypeError):
            call(x)
    with pytest.raises(TypeError):              # the histogram takes keys
        ops.byte_histogram(torch.zeros(3), 0, 0, shift=24)


def _grid(x, G, Q):
    pv = _pivots(x)
    return pv[np.arange(G * Q) % len(pv)].reshape(G, Q)


@pytest.mark.parametrize("dtype", DTYPES)
def test_segmented_count_extract_matches_jax(dtype):
    x = _data(dtype, seed=9)
    rng = np.random.default_rng(9)
    keys = rng.integers(-1, 5, size=N).astype(np.int32)   # -1, 4: no group
    keys[keys == 2] = 4                                   # group 2 is empty
    grid = _grid(x, 4, 3)
    xt, kt = as_device_tensor(x, "cpu"), torch.from_numpy(keys)
    gt = as_device_tensor(grid, "cpu")
    with _x64(dtype):
        for cap in (1, 37, N):
            want = jops.segmented_count_extract(
                jnp.asarray(x), jnp.asarray(keys), jnp.asarray(grid), cap,
                backend="jnp")
            got = ops.segmented_count_extract(xt, kt, gt, cap)
            for g, w in zip(got, want):
                assert tbits(g) == jbits(w), (dtype, cap)


@pytest.mark.parametrize("dtype", ("float32", "bfloat16", "float64"))
def test_plain_band_versions_match_jax_on_nan(dtype):
    """Quiet NaNs of both signs among +-inf and both zeros, and NaN pivots.
    The two contracts differ and each follows its JAX reference: the fused
    counts put a NaN in gt (n - lt - eq), the segmented ones on no side;
    neither puts a NaN in a band, and a NaN pivot has no band."""
    x = _data(dtype, seed=11).astype(np.float64)
    x[::5] = np.nan
    x[2::9] = -np.nan
    x = x.astype(_np_dtype(dtype))
    assert np.signbit(x[2]) and not np.signbit(x[0])
    finite = x[~np.isnan(x.astype(np.float64))]
    pv = np.concatenate([_pivots(finite),
                         np.array([np.nan, -np.nan]).astype(x.dtype)])
    rng = np.random.default_rng(11)
    keys = rng.integers(-1, 4, size=N).astype(np.int32)
    grid = pv[np.arange(3 * 4) % len(pv)].reshape(3, 4)
    xt, kt = as_device_tensor(x, "cpu"), torch.from_numpy(keys)
    with _x64(dtype):
        for cap in (37, N):
            want = jops.segmented_count_extract(
                jnp.asarray(x), jnp.asarray(keys), jnp.asarray(grid), cap,
                backend="jnp")
            got = ops.segmented_count_extract(xt, kt,
                                              as_device_tensor(grid, "cpu"),
                                              cap)
            for g, w in zip(got, want):
                assert tbits(g) == jbits(w), (dtype, cap)
            for pivot in pv:
                want = _jax_fused(x, pivot, cap)
                got = ops.fused_count_extract(
                    xt, as_device_tensor(pivot.reshape(1), "cpu")[0], cap)
                for g, w in zip(got, want):
                    assert tbits(g) == jbits(w), (dtype, cap, pivot)


def test_interpret_counting_kernels_match_plain():
    """The four Pallas kernels themselves (interpret mode) against the
    port: partition_count, band_count, byte_histogram, segmented_select."""
    x = _data("float32", seed=10)
    jx, xt = jnp.asarray(x), as_device_tensor(x, "cpu")
    p, q = x[500], x[17]
    assert tbits(ops.count3(xt, _scalar(p))) == jbits(
        jops.count3(jx, jnp.asarray(p), backend="interpret"))
    assert tbits(ops.band_count(xt, _scalar(q), _scalar(p))) == jbits(
        jops.band_count(jx, jnp.asarray(q), jnp.asarray(p),
                        backend="interpret"))
    ju = jops.to_sortable_u32(jx)
    top = int(np.asarray(ju)[3]) & 0xFF000000
    assert tbits(ops.byte_histogram(ops.to_sortable_u32(xt), top, 0xFF000000,
                                    shift=16)) == jbits(
        jops.byte_histogram(ju, top, 0xFF000000, shift=16,
                            backend="interpret"))
    keys = (np.arange(N) % 3 - 1).astype(np.int32)       # -1: no group
    grid = np.array([[p, q], [q, x[900]]], dtype=np.float32)
    want = jops.segmented_count_extract(jx, jnp.asarray(keys),
                                        jnp.asarray(grid), 37,
                                        backend="interpret")
    got = ops.segmented_count_extract(xt, torch.from_numpy(keys),
                                      torch.from_numpy(grid), 37)
    for g, w in zip(got, want):
        assert tbits(g) == jbits(w)
