"""The port's ``quantile_clip_by_value`` (radix and gk_select) against the
JAX package's, bit for bit (inputs and helpers:
``test_torch_quantile_ops.py``)."""
import numpy as np
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



def test_a_16_bit_leaf_clips_to_its_nearest_value_as_jax():
    """A tree of an f32 and a bf16 leaf whose 0.6-quantile, 1.005, is the
    f32 leaf's and lies between two bf16 values (1.0 and 1.0078125, the
    nearer).  Both packages clip the bf16 leaf's larger values to 1.005
    in f32 and round to the nearest bf16, 1.0078125, above the threshold
    (``ROADMAP.md`` Queue 3): the port mirrors the reference, bit for
    bit."""
    f32 = np.array([0.5, 1.005], np.float32)
    bf16 = np.array([0.25, 1.0078125, -3.0], np.float32)
    jc, jthr = J.quantile_clip_by_value(
        {"a": jnp.asarray(f32), "b": jnp.asarray(bf16, jnp.bfloat16)}, 0.6)
    tc, tthr = T.quantile_clip_by_value(
        {"a": torch.from_numpy(f32),
         "b": torch.from_numpy(bf16).to(torch.bfloat16)}, 0.6)
    assert tb(tthr) == jb(jthr) and float(tthr) == float(np.float32(1.005))
    assert tb(tc["a"]) == jb(jc["a"]) and tb(tc["b"]) == jb(jc["b"])
    assert tc["b"].float().tolist() == [0.25, 1.0078125, -1.0078125]
    assert float(tc["b"].float().abs().max()) > float(tthr)
