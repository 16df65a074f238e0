"""The port's ``quantile_clip_by_value`` (radix and gk_select) against the
JAX package's, bit for bit (inputs and helpers:
``test_torch_quantile_ops.py``)."""
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402
from _grid import DTYPES                                      # noqa: E402
from repro.optim import quantile_ops as J                     # noqa: E402
from repro_torch.optim import quantile_ops as T               # noqa: E402

from test_torch_quantile_ops import (_map, _t, _tree, _x64, jb, tb)  # noqa: E402


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
