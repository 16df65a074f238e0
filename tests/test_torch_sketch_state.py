"""XLA's blocked f32 cumsum in the port, and the sketch state carried
between the packages, bit for bit (inputs and helpers:
``test_torch_sketch.py``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402
from _grid import DTYPES                                      # noqa: E402
from repro_torch.core import sketch as T                      # noqa: E402

from test_torch_sketch import (_jax_stacked, _t, _x64, assert_state,
    jb, tb)


@pytest.mark.parametrize("n", [1, 2, 15, 16, 17, 255, 256, 257, 4097, 9000])
def test_blocked_cumsum_is_jax_cumsum(n):
    """``jnp.cumsum`` of float32 is XLA's blocked scan; the port adds in the
    same order."""
    rng = np.random.default_rng(n)
    w = (rng.integers(0, 60, size=n) * np.float32(0.70710677)).astype(
        np.float32)
    assert jb(jax.jit(jnp.cumsum)(w)) == tb(T.blocked_cumsum(_t(w)))


@pytest.mark.parametrize("dtype", DTYPES)
def test_state_converter_round_trips_a_jax_state(dtype):
    with _x64(dtype):
        js, _ = _jax_stacked(dtype, 3, 3, seed=17)
        leaves = [np.asarray(a) for a in js]
        if dtype == "bfloat16":
            leaves[0] = leaves[0].view(np.uint16)    # checkpoint storage
        ts = T.sketch_state_from_numpy(*leaves, device="cpu")
        assert_state(js, ts)
        back = T.sketch_state_to_numpy(ts)
        for a, b in zip(leaves, back):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        # an ml_dtypes bfloat16 array converts as well
        ts2 = T.sketch_state_from_numpy(*[np.asarray(a) for a in js],
                                        device="cpu")
        assert_state(js, ts2)
