"""The port's ``optim/quantile_ops.py`` against the JAX package, bit for bit.

The same numpy inputs from a seed go through ``repro.optim.quantile_ops``
and ``repro_torch.optim.quantile_ops``: ``pytree_exact_quantile`` and
``pytree_radix_quantile`` (1, 4 and 8 bits a pass) over pytrees of several
ragged leaves, ``channelwise_exact_quantile`` over dense channels along
``axis`` 0 and -1 and over ragged channels with an empty one, and
``quantile_clip_by_value`` with both methods, over the f32/bf16/int32/f64
grid of ``tests/_grid.py`` (f64 under ``jax.enable_x64``).  Tolerance is
zero: raw bytes compare.  Every answer is also the numpy sort oracle's.
"""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402

from _grid import DTYPES, make_case, oracle_kth               # noqa: E402
from repro.optim import quantile_ops as J                     # noqa: E402
from repro_torch.core import as_device_tensor                 # noqa: E402
from repro_torch.optim import quantile_ops as T               # noqa: E402

QS = (0.001, 0.5, 0.999, 1.0)


def _x64(dtype):
    return (jax.enable_x64(True) if dtype == "float64"
            else contextlib.nullcontext())


def tb(t):
    view = {2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()]
    return t.contiguous().view(view).numpy().tobytes()


def jb(a):
    return np.asarray(a).tobytes()


def _t(a):
    return as_device_tensor(np.array(a), "cpu")


def _tree(dtype, seed=0):
    """Leaves of 37, 5 x 70, 1 and 300 values (some signed zeros), in a
    dict with unsorted keys, a list and a tuple."""
    sizes = (37, 350, 1, 300)
    flat = make_case("uniform", dtype, sum(sizes), seed=seed)
    flat[3] = -0.0 if dtype != "int32" else 0
    flat[40] = 0.0 if dtype != "int32" else -1
    parts = np.split(flat, np.cumsum(sizes)[:-1])
    tree = {"b": parts[0], "a": [parts[1].reshape(5, 70), (parts[2],)],
            "c": parts[3]}
    return tree, np.abs(flat.astype(np.float32))


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


@pytest.mark.parametrize("dtype", DTYPES)
def test_pytree_exact_quantile_matches_jax(dtype):
    """The JAX side jitted, as ``quantile_clip_by_value`` runs it (eager,
    every op compiles on its first call: about 10 s a dtype here)."""
    exact = jax.jit(J.pytree_exact_quantile,
                    static_argnames=("q", "eps", "chunk"))
    with _x64(dtype):
        tree, absf = _tree(dtype)
        jt, tt = _map(jnp.asarray, tree), _map(_t, tree)
        for q in QS:
            for eps, chunk in ((1e-3, 64), (0.05, 1 << 16)):
                want = exact(jt, q, eps=eps, chunk=chunk)
                got = T.pytree_exact_quantile(tt, q, eps=eps, chunk=chunk)
                assert tb(got) == jb(want), (q, eps, chunk)
            k = max(1, int(np.ceil(q * absf.size)))
            assert tb(got) == oracle_kth(absf, k).tobytes()


@pytest.mark.parametrize("dtype", DTYPES)
def test_pytree_radix_quantile_matches_jax(dtype):
    """Three leaves (each padded to one 2^20 chunk); the JAX side jitted
    (its eager ``fori_loop`` compiles on every call).  8 bits a pass (256
    bucket reads a digit) is held against the sort oracle only: it costs
    JAX about 10 s a call here."""
    radix = jax.jit(J.pytree_radix_quantile,
                    static_argnames=("q", "passes", "bits_per_pass"))
    with _x64(dtype):
        tree, _ = _tree(dtype, seed=1)
        tree = {"c": tree["c"], "a": [tree["a"][0][:2], tree["a"][1]]}
        absf = np.abs(np.concatenate(
            [tree["a"][0].ravel(), tree["a"][1][0], tree["c"]]
        ).astype(np.float32))
        jt, tt = _map(jnp.asarray, tree), _map(_t, tree)
        for q in QS:
            k = max(1, int(np.ceil(q * absf.size)))
            for bits in (1, 4):
                want = radix(jt, q, bits_per_pass=bits)
                got = T.pytree_radix_quantile(tt, q, bits_per_pass=bits)
                assert tb(got) == jb(want), (q, bits)
                assert tb(got) == oracle_kth(absf, k).tobytes()
        got = T.pytree_radix_quantile(tt, 0.5, bits_per_pass=8)
        k = max(1, int(np.ceil(0.5 * absf.size)))
        assert tb(got) == oracle_kth(absf, k).tobytes()
    with pytest.raises(ValueError):
        T.pytree_radix_quantile({}, 0.5)


@pytest.mark.parametrize("dtype", DTYPES)
def test_channelwise_exact_quantile_matches_jax(dtype):
    with _x64(dtype):
        x = make_case("zipf" if dtype == "int32" else "uniform", dtype,
                      6 * 33 * 5, seed=2).reshape(6, 33, 5)
        for axis in (0, -1):
            for q in (0.001, 0.5, 0.999):
                want = J.channelwise_exact_quantile(jnp.asarray(x), q,
                                                    axis=axis)
                got = T.channelwise_exact_quantile(_t(x), q, axis=axis)
                assert tb(got) == jb(want), (axis, q)
                xc = np.moveaxis(x, axis, 0).reshape(x.shape[axis], -1)
                k = max(1, int(np.ceil(q * xc.shape[1])))
                assert tb(got) == np.stack(
                    [oracle_kth(c, k) for c in xc]).tobytes()
        # ragged channels, one empty, sizes not divisible by the partitions
        flat = make_case("ties", dtype, 5 + 17 + 1 + 40, seed=3)
        chans = np.split(flat, [5, 5, 22, 23])
        assert chans[1].size == 0
        for q in (0.001, 0.5, 0.999):
            want = J.channelwise_exact_quantile(
                [jnp.asarray(c) for c in chans], q)
            got = T.channelwise_exact_quantile([_t(c) for c in chans], q)
            assert tb(got) == jb(want), q
    with pytest.raises(ValueError):
        T.channelwise_exact_quantile([], 0.5)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("method", ["radix", "gk_select"])
def test_quantile_clip_by_value_matches_jax(dtype, method):
    with _x64(dtype):
        tree, _ = _tree(dtype, seed=4)
        jt, tt = _map(jnp.asarray, tree), _map(_t, tree)
        for q in (0.5, 0.999):
            jc, jthr = J.quantile_clip_by_value(jt, q, method=method)
            tc, tthr = T.quantile_clip_by_value(tt, q, method=method)
            assert tb(tthr) == jb(jthr), q
            jl, tl = jax.tree.leaves(jc), T.tree_leaves(tc)
            assert len(jl) == len(tl) == 4
            for a, b in zip(jl, tl):
                assert tb(b) == jb(a), q
            assert isinstance(tc["a"][1], tuple)
