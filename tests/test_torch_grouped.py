"""The port's grouped engine against the JAX package, bit for bit.

The same numpy inputs from a seed go through ``repro.core.grouped`` and
``repro_torch.core.grouped``: the exact rank rule ``target_rank_traced``, the
segmented sketch, the per-group pivot query, the plain segmented round,
``engine.phase_resolve``, and ``gk_select_grouped`` in both modes over the
f32/bf16/int32/f64 grid with shards {1, 3}, empty groups, keys outside
[0, G), heavy ties, signed zeros and the ``ks`` override.  The JAX side runs
on its jnp backend.  Tolerance is zero: raw bytes compare, so a zero's sign
counts.  The segmented kernel itself is held against the plain round on the
card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.

The cases are split over this file and ``test_torch_grouped_grid.py``, so
that xdist's ``--dist loadfile`` can run them on several workers; those
files import their helpers from here.
"""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402

from _grid import DTYPES, _np_dtype, make_case                # noqa: E402
from repro.core import engine as jengine                      # noqa: E402
from repro.core import grouped as jgr                         # noqa: E402
from repro.core import local_ops as jlo                       # noqa: E402
import repro_torch                                            # noqa: E402
from repro_torch.core import as_device_tensor                 # noqa: E402
from repro_torch.core import engine as tengine                # noqa: E402
from repro_torch.core import grouped as tgr                   # noqa: E402
from repro_torch.core import local_ops as tlo                 # noqa: E402
from repro_torch.kernels import ops                           # noqa: E402

G, N_I, EPS = 5, 240, 0.05
QS = (0.001, 0.5, 0.999)


def _x64(dtype):
    return jax.enable_x64(True) if dtype == "float64" else contextlib.nullcontext()


def tb(t):
    view = {2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()]
    return tuple(t.shape), t.contiguous().view(view).numpy().tobytes()


def jb(a):
    a = np.asarray(a)
    return a.shape, a.tobytes()


def _t(a):
    return as_device_tensor(np.array(a), "cpu")


def _values(dist, dtype, shards, seed=0):
    n = shards * N_I
    if dist == "signed_zeros":
        rng = np.random.default_rng(seed)
        table = np.array([-0.0, 0.0, -1.0, 1.0, 2.0, 0.0, -0.0])
        v = table[rng.integers(0, len(table), size=n)].astype(_np_dtype(dtype))
    else:
        v = make_case(dist, dtype, n, seed=seed)
    return v.reshape(shards, N_I)


def _keys(shards, seed=0):
    """Keys in [-1, G]: -1 and G belong to no group; group 1 is empty."""
    rng = np.random.default_rng(seed + 100)
    k = rng.integers(-1, G + 1, size=(shards, N_I)).astype(np.int32)
    k[k == 1] = G
    return k


def test_target_rank_traced_matches_jax_and_host_rule():
    ns = [0, 1, 2, 7, 2 ** 24 - 1, 2 ** 24, 2 ** 24 + 1, 10 ** 9, 2 ** 31 - 1]
    for q in (2.0 ** -60, 1e-9, 0.1, 1 / 3, 0.5, 0.99, 1.0):
        got = tlo.target_rank_traced(torch.tensor(ns, dtype=torch.int32), q)
        want = jlo.target_rank_traced(jnp.asarray(ns, jnp.int32), q)
        assert tb(got) == jb(want), q
        assert got.tolist() == [jlo.exact_target_rank(n, q) for n in ns], q
        assert got.tolist() == [tlo.exact_target_rank(n, q) for n in ns], q
    for q in (0.0, -0.5, 1.5):
        with pytest.raises(ValueError):
            tlo.target_rank_traced(torch.tensor([3]), q)


@pytest.mark.parametrize("dtype", DTYPES)
def test_grouped_pieces_match_jax(dtype):
    """segmented_sketch_local, query_grouped_sketch, grouped_target_ranks,
    grouped_count_extract and phase_resolve, one shard batch through both."""
    v = _values("zipf", dtype, 3, seed=4)
    k = _keys(3, seed=4)
    s = tgr.grouped_sketch_samples(EPS, N_I)
    assert s == jgr.grouped_sketch_samples(EPS, N_I)
    with _x64(dtype):
        jv, jk = jnp.asarray(v), jnp.asarray(k)
        jout = jax.vmap(lambda a, b: jgr.segmented_sketch_local(a, b, G, s))(
            jv, jk)
        tout = tgr.segmented_sketch_local(_t(v), _t(k), G, s)
        for got, want in zip(tout, jout):
            assert tb(got) == jb(want)
        vals, wts, counts, slack = jout
        g_vals = jnp.moveaxis(vals, 0, 1).reshape(G, -1)
        g_wts = jnp.moveaxis(wts, 0, 1).reshape(G, -1)
        n_g, sl = counts.sum(0), slack.sum(0)
        kmat = jgr.grouped_target_ranks(n_g, QS)
        tkmat = tgr.grouped_target_ranks(_t(n_g).to(torch.int32), QS)
        assert tb(tkmat) == jb(kmat)
        jpiv = jgr.query_grouped_sketch(g_vals, g_wts, sl, kmat)
        tpiv = tgr.query_grouped_sketch(_t(g_vals), _t(g_wts),
                                        _t(sl).to(torch.int32), tkmat)
        assert tb(tpiv) == jb(jpiv)

        cap = 12
        jc, jbl, jab = jax.vmap(
            lambda a, b: jlo.grouped_count_extract(a, b, jpiv, cap))(jv, jk)
        tc, tbl, tab = tlo.grouped_count_extract(_t(v), _t(k), tpiv, cap)
        for got, want in ((tc, jc), (tbl, jbl), (tab, jab)):
            assert tb(got) == jb(want)
        R = G * len(QS)
        jcnt = jc.sum(0).reshape(R, 3)
        jbelow = jnp.moveaxis(jbl, 0, 2).reshape(R, -1)
        jabove = jnp.moveaxis(jab, 0, 2).reshape(R, -1)
        want = jengine.phase_resolve(jpiv.reshape(R), kmat.reshape(R), jcnt,
                                     jbelow, jabove, cap)
        got = tengine.phase_resolve(
            tpiv.reshape(R), tkmat.reshape(R),
            tc.sum(0, dtype=torch.int32).reshape(R, 3),
            tbl.permute(1, 2, 0, 3).reshape(R, -1),
            tab.permute(1, 2, 0, 3).reshape(R, -1), cap)
        assert tb(got) == jb(want)


def test_gk_select_grouped_block_select_matches_jax():
    """The JAX package's own block_select mode agrees as well."""
    v, k = _values("uniform", "float32", 3), _keys(3)
    want = np.asarray(jgr.gk_select_grouped(
        jnp.asarray(v), jnp.asarray(k), QS, num_groups=G, eps=EPS,
        block_select=True))
    got = repro_torch.gk_select_grouped(v, k, QS, num_groups=G, eps=EPS,
                                        block_select=True, device="cpu")
    assert tb(got) == jb(want)


def test_ks_override_matches_jax():
    v, k = _values("zipf", "float32", 3, seed=6), _keys(3, seed=6)
    jv, jk = jnp.asarray(v), jnp.asarray(k)
    for qs, ks in (((0.5,), 7), (QS, 7), ((0.5,), (1, 3, 5, 9, 2)),
                   (QS, (1, 3, 5, 9, 2))):
        want = np.asarray(jgr.gk_select_grouped(jv, jk, qs, num_groups=G,
                                                eps=EPS, ks=ks))
        got = repro_torch.gk_select_grouped(v, k, qs, num_groups=G, eps=EPS,
                                            ks=ks, device="cpu")
        assert tb(got) == jb(want), (qs, ks)
    grid = np.arange(1, 16).reshape(G, 3)                 # one rank per cell
    assert tb(tgr.grouped_target_ranks(torch.zeros(G, dtype=torch.int32), QS,
                                       grid)) == jb(
        jgr.grouped_target_ranks(jnp.zeros(G, jnp.int32), QS, grid))


def test_pass_counter_and_entry_checks():
    v, k = _values("uniform", "float32", 3), _keys(3)
    ops.reset_hbm_passes()
    repro_torch.gk_select_grouped(v, k, QS, num_groups=G, eps=EPS,
                                  block_select=True, device="cpu")
    assert ops.hbm_passes() == 3 * G * len(QS)       # the plain round
    with pytest.raises(ValueError):
        repro_torch.gk_select_grouped(v.reshape(-1), k.reshape(-1), QS,
                                      num_groups=G, device="cpu")
    bad = v.copy()
    bad[0, 3] = np.nan
    with pytest.raises(ValueError, match="NaN"):
        repro_torch.gk_select_grouped(bad, k, QS, num_groups=G, device="cpu")
    with pytest.raises(ValueError):
        tgr.grouped_sketch_samples(0.0, 10)


def test_sketch_in_chunks_equals_one_pass(monkeypatch):
    """The sketch phase sorts a chunk of shards at a time at full size; the
    answer does not depend on the chunk."""
    v, k = _t(_values("zipf", "float32", 3, seed=8)), _t(_keys(3, seed=8))
    whole = tgr._sketch(v, k, G, 40)
    monkeypatch.setattr(tgr, "_SKETCH_CHUNK_ELEMS", N_I)
    for a, b in zip(tgr._sketch(v, k, G, 40), whole):
        assert torch.equal(a, b)
