"""The port's serving entry point (``repro_torch.launch.serve``) and its
``StreamingCalibrator`` against the JAX package, bit for bit.

- ``calibrate_int8_scale`` and ``calibrate_int8_scales`` on the same numpy
  inputs over the f32/bf16/int32/f64 grid of ``tests/_grid.py``, at sizes
  that ``num_partitions`` does not divide: raw bytes equal JAX's and the
  numpy sort oracle's at rank ceil(q n).
- ``generate`` with a ``StreamingCalibrator``: the port's own per-step
  logits also go through JAX's calibrator (the two models' logits differ in
  the last bits, so the calibrations are compared on the same tensors,
  never across the models).  ``scale``, ``approx_scale`` and ``observed``
  equal JAX's, synchronous and threaded, ``fused`` both ways; ``scale`` is
  the sort oracle's.  With one worker the pool folds its buffers in a fixed
  order, so the approximate scale is JAX's too; with two the fold grouping
  depends on timing and it is held to the sketch's rank bound.
- ``main()`` with ``--arch granite-8b --reduced --device cpu --calibrate
  --ingest-threads 2``.

The cases are split over this file and ``test_torch_serve_stream.py``, so
that xdist's ``--dist loadfile`` can run them on several workers; those
files import their helpers from here.
"""
import contextlib
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402

from _grid import DTYPES, make_case, oracle_kth               # noqa: E402
from repro.launch import serve as JS                          # noqa: E402
from repro_torch.core import as_device_tensor                 # noqa: E402
from repro_torch.launch import serve as TS                    # noqa: E402

Q = 0.999
GEN = 6
LIMIT_S = 120


def _x64(dtype):
    return (jax.enable_x64(True) if dtype == "float64"
            else contextlib.nullcontext())


def tb(t):
    return t.contiguous().view(torch.int32).numpy().tobytes()


def jb(a):
    return np.asarray(a).tobytes()


def _t(a):
    return as_device_tensor(np.array(a), "cpu")


def _abs_f32(x):
    return np.abs(np.asarray(x).astype(np.float32))


@pytest.mark.parametrize("dtype", DTYPES)
def test_calibrate_int8_scale_matches_jax(dtype):
    with _x64(dtype):
        for dist, n in (("uniform", 1001), ("ties", 203), ("zipf", 77)):
            x = make_case(dist, dtype, n, seed=1).reshape(n, 1)
            for q in (0.5, 0.999, 1.0):
                for parts in (8, 3):
                    want = JS.calibrate_int8_scale(jnp.asarray(x), q,
                                                   num_partitions=parts)
                    got = TS.calibrate_int8_scale(x, q, num_partitions=parts,
                                                  device="cpu")
                    assert tb(got) == jb(want), (dist, q, parts)
                k = min(n, max(1, math.ceil(q * n)))
                assert tb(got) == oracle_kth(_abs_f32(x), k).tobytes()


@pytest.mark.parametrize("dtype", DTYPES)
def test_calibrate_int8_scales_matches_jax(dtype):
    with _x64(dtype):
        x = make_case("uniform", dtype, 7 * 13 * 5, seed=2).reshape(7, 13, 5)
        for axis in (-1, 0, 1):
            for q in (0.5, 0.999):
                want = JS.calibrate_int8_scales(jnp.asarray(x), axis, q)
                got = TS.calibrate_int8_scales(_t(x), axis, q, device="cpu")
                assert tb(got) == jb(want), (axis, q)
                xc = np.moveaxis(_abs_f32(x), axis, 0).reshape(
                    x.shape[axis], -1)
                k = max(1, math.ceil(q * xc.shape[1]))
                assert tb(got) == np.stack(
                    [oracle_kth(c, k) for c in xc]).tobytes()
