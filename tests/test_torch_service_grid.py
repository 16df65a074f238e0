"""The port's ``QuantileService`` against the JAX package's in bfloat16,
int32 and float64: the scripted sequence of ``tests/_service_script.py``,
the port with ``fused`` both ways, bit for bit."""
import pytest

pytest.importorskip("torch")

from _service_script import (TORCH, _assert_same, _jax_record,  # noqa: E402
                             script)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("dtype", ["bfloat16", "int32", "float64"])
def test_scripted_sequence_matches_jax(dtype, fused):
    _assert_same(_jax_record(script, dtype, fused),
                 script(TORCH, dtype, fused), fused)
