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
    ops.reset_hbm_passes()
    ops.fused_count_extract(x, x[0, 0], 10)
    assert ops.hbm_passes() == 3
    ops.reset_hbm_passes()
    ops.fused_count_extract_multi(x, x[0, :4], 10)
    assert ops.hbm_passes() == 12
    assert fs.launches_for(5) == 1 and fs.launches_for(9) == 2


def test_dispatch_routes_by_device():
    assert dispatch.route(torch.zeros(2)) == dispatch.PLAIN
    with pytest.raises(ValueError):
        dispatch.route(torch.zeros(2, device="meta"))
    with pytest.raises(ValueError):       # wrappers take CUDA tensors only
        fs.fused_select(torch.zeros(2, 8), torch.tensor(0.0), 2)
    with pytest.raises(ValueError):
        ref.block_topk_ref(torch.zeros(8), torch.tensor(0.0), 9, True)


def test_make_fused_fns_are_the_seams():
    x = torch.randn(2, 64)
    c1 = ops.make_fused_fn()(x, x[0, 3], 5)
    c2 = ops.fused_count_extract(x, x[0, 3], 5)
    assert all(torch.equal(a, b) for a, b in zip(c1, c2))
    m1 = ops.make_fused_multi_fn()(x, x[0, :2], 5)
    m2 = ops.fused_count_extract_multi(x, x[0, :2], 5)
    assert all(torch.equal(a, b) for a, b in zip(m1, m2))
