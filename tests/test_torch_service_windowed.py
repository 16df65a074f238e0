"""The port's windowed ``QuantileService`` against the JAX package's: the
windowed sequence of ``tests/_service_script.py`` (``window_ticks=6,
window_subs=3``) in float32 and bfloat16, the port with ``fused`` both
ways, bit for bit."""
import pytest

pytest.importorskip("torch")

from _service_script import (TORCH, _assert_same, _jax_record,  # noqa: E402
                             windowed_script)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_windowed_sequence_matches_jax(dtype, fused):
    _assert_same(_jax_record(windowed_script, dtype, fused),
                 windowed_script(TORCH, dtype, fused), fused)
