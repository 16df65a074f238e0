"""The port's ``channelwise_exact_quantile`` against the JAX package's, bit
for bit (inputs and helpers: ``test_torch_quantile_ops.py``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                       # noqa: E402
from _grid import DTYPES, make_case, oracle_kth               # noqa: E402
from repro.optim import quantile_ops as J                     # noqa: E402
from repro_torch.optim import quantile_ops as T               # noqa: E402

from test_torch_quantile_ops import (_t, _x64, jb, tb)  # noqa: E402


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
