"""The port's ``gk_select_grouped`` in both modes against the JAX
package's over the f32/bf16/int32/f64 grid, bit for bit (inputs and
helpers: ``test_torch_grouped.py``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                       # noqa: E402
from _grid import DTYPES                                      # noqa: E402
from repro.core import grouped as jgr                         # noqa: E402
import repro_torch                                            # noqa: E402

from test_torch_grouped import (EPS, G, QS, _keys, _values, _x64, jb,
    tb)


def _dists(dtype):
    base = ["uniform", "zipf", "all_equal", "ties"]
    return base + ([] if dtype == "int32" else ["signed_zeros"])


@pytest.mark.parametrize("shards", (1, 3))
@pytest.mark.parametrize("dtype", DTYPES)
def test_gk_select_grouped_matches_jax(dtype, shards):
    k = _keys(shards, seed=shards)
    for dist in _dists(dtype):
        v = _values(dist, dtype, shards, seed=shards)
        with _x64(dtype):
            want = np.asarray(jgr.gk_select_grouped(
                jnp.asarray(v), jnp.asarray(k), QS, num_groups=G, eps=EPS))
        for block_select in (False, True):
            got = repro_torch.gk_select_grouped(
                v, k, QS, num_groups=G, eps=EPS, block_select=block_select,
                device="cpu")
            assert tb(got) == jb(want), (dist, block_select)
    # an empty group answers the high sentinel
    assert tb(got[1]) == tb(torch.full_like(got[1], float("inf"))
                            if got.is_floating_point()
                            else torch.full_like(got[1], 2 ** 31 - 1))
