"""The count-and-discard selects at the dtype extremes (where the
reference's single-process loop gives another element) and their rounds,
and the full-sort and sketch-only baselines against JAX (helpers:
``test_torch_baselines.py``)."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402
from _grid import make_case, oracle_quantile                  # noqa: E402
from repro.core import baselines as jb                        # noqa: E402
from repro_torch.core import baselines as tb                  # noqa: E402

from test_torch_baselines import (N_I, QS, _bytes, _t)  # noqa: E402


def _extreme_case(kind):
    """The reviewed extremes: (4, 64) normal f32 with five +inf and three
    -inf; int32 in [-100, 100) with 4 x iinfo.min and 8 x iinfo.max."""
    rng = np.random.default_rng(0)
    if kind == "f32_inf":
        x = rng.normal(size=256).astype(np.float32)
        x[rng.choice(256, 8, replace=False)] = [np.inf] * 5 + [-np.inf] * 3
    else:
        x = rng.integers(-100, 100, size=256).astype(np.int32)
        info = np.iinfo(np.int32)
        x[rng.choice(256, 12, replace=False)] = [info.min] * 4 + [info.max] * 8
    return x.reshape(4, 64)


# where the reference's single-process loop empties its band and returns
# another element after all its 128 rounds (ROADMAP.md Queue 3 item 5):
# every case but the median, with both seeds
JAX_DIFFERS = {(kind, name, q) for kind in ("f32_inf", "int32_extremes")
               for name in ("afs_select", "jeffers_select")
               for q in (0.0, 0.01, 0.99, 1.0)}


@pytest.mark.parametrize("kind", ["f32_inf", "int32_extremes"])
def test_extremes_equal_the_sort_where_jax_does_not(kind):
    x = _extreme_case(kind)
    tx = _t(x)
    jx = jnp.asarray(x)
    for q in QS:
        want = _t(np.asarray(oracle_quantile(x, q)).reshape(1))
        assert tb.count_discard_rounds(tx, q) <= 20, q
        for name in ("afs_select", "jeffers_select"):
            got = getattr(tb, name)(tx, q)
            assert _bytes(got.reshape(1)) == _bytes(want), (q, name)
            jgot = getattr(jb, name)(jx, q)
            differs = _bytes(np.asarray(jgot).reshape(1)) != _bytes(want)
            assert differs == ((kind, name, q) in JAX_DIFFERS), (q, name)
        if (kind, "afs_select", q) in JAX_DIFFERS:
            # count_discard_rounds' body, jitted (eager, its while_loop
            # dispatches op by op)
            rounds = jax.jit(jb._count_discard, static_argnames=(
                "q", "max_rounds", "seed"))(jx, q, max_rounds=128, seed=0)[1]
            assert int(rounds) == 128


def test_count_discard_rounds_are_logarithmic():
    """Normal data at n = 4 x 4096 over five seeds: each select takes
    O(log n) rounds (the expectation is about 2 ln n = 17; the bound is 4
    log2 n = 56), and the answer is the sort's."""
    n = 4 * 4096
    rounds = []
    for seed in range(5):
        x = np.random.default_rng(seed).normal(size=(4, 4096)).astype(
            np.float32)
        tx = _t(x)
        for q in (0.5, 0.99):
            r = tb.count_discard_rounds(tx, q, seed=seed)
            rounds.append(r)
            assert 1 <= r <= 4 * math.log2(n), (seed, q, r)
            assert float(tb.afs_select(tx, q, seed=seed)) == float(
                oracle_quantile(x, q))
    assert sum(rounds) / len(rounds) <= 2 * math.log2(n)


def test_full_sort_and_approx_keep_their_answers():
    x = make_case("uniform", "float32", 3 * N_I).reshape(3, N_I)
    for q in (0.01, 0.5, 0.99):
        assert _bytes(tb.full_sort_quantile(_t(x), q).reshape(1)) == _bytes(
            np.asarray(jb.full_sort_quantile(jnp.asarray(x), q)).reshape(1))
        assert _bytes(tb.approx_quantile(_t(x), q).reshape(1)) == _bytes(
            np.asarray(jb.approx_quantile(jnp.asarray(x), q)).reshape(1))
