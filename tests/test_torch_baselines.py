"""The port's baselines (``repro_torch.core.baselines``) and roofline terms
(``repro_torch.launch.roofline``) against the JAX package's.

- ``psrs_sort``: the same numpy inputs through both packages over
  ``tests/_grid.py``'s dtypes and distributions, shards {1, 3, 6}, plus
  signed zeros and ties; tolerance zero (raw bytes, so a zero's sign and
  the order of equal values count).
- ``afs_select`` and ``jeffers_select``: equal, as raw bytes, to the sort
  oracle over the grid at q in {0, 0.01, 0.5, 0.99, 1}, except that an
  answer of zero may be either zero: the answer is the random pivot that
  holds rank k, in both packages, and -0.0 and +0.0 tie.  Their pivots
  come from a ``torch.Generator`` where JAX draws threefry, so their
  rounds are held to an O(log n) bound, not to JAX's count.
- At the dtype extremes (+-inf, the int32 extremes) the port gives the
  sort's answer in a few rounds; the cases where JAX's single-process loop
  gives another element after all its 128 rounds are pinned by name.
- ``model_flops`` equal to the reference's for every configuration;
  ``kernel_roofline`` and ``roofline_terms`` under the H100's rates.

The cases are split over this file and
``test_torch_baselines_extremes.py`` and ``test_torch_roofline.py``, so
that xdist's ``--dist loadfile`` can run them on several workers; those
files import their helpers from here.
"""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402

from _grid import (DISTRIBUTIONS, DTYPES, SHARD_COUNTS,       # noqa: E402
                   _np_dtype, make_case, oracle_quantile)
from repro.core import baselines as jb                        # noqa: E402
import repro_torch                                            # noqa: E402
from repro_torch.core import as_device_tensor                 # noqa: E402
from repro_torch.core import baselines as tb                  # noqa: E402

N_I = 100                        # not a multiple of the 32 regular samples
QS = (0.0, 0.01, 0.5, 0.99, 1.0)


def _x64(dtype):
    return (jax.enable_x64(True) if dtype == "float64"
            else contextlib.nullcontext())


def _bytes(a):
    a = a.contiguous().view({2: torch.int16, 4: torch.int32,
                             8: torch.int64}[a.element_size()]).numpy() \
        if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.shape, a.tobytes()


def _t(a):
    return as_device_tensor(np.array(a), "cpu")


def _cases(dtype):
    """(name, (P, N_I) values) of the grid, and signed zeros among ties."""
    for dist in DISTRIBUTIONS:
        for shards in SHARD_COUNTS:
            yield (f"{dist}-{shards}",
                   make_case(dist, dtype, shards * N_I).reshape(shards, N_I))
    if dtype != "int32":
        rng = np.random.default_rng(7)
        table = np.array([-0.0, 0.0, -1.0, 1.0, 2.0, 0.0, -0.0])
        v = table[rng.integers(0, len(table), size=3 * N_I)]
        yield "signed_zeros-3", v.astype(_np_dtype(dtype)).reshape(3, N_I)


@pytest.mark.parametrize("dtype", DTYPES)
def test_psrs_sort_matches_jax_bit_for_bit(dtype):
    with _x64(dtype):
        for name, x in _cases(dtype):
            want = jb.psrs_sort(jnp.asarray(x))
            got = tb.psrs_sort(_t(x))
            assert _bytes(got) == _bytes(want), name
    assert repro_torch.psrs_sort is tb.psrs_sort


@pytest.mark.parametrize("dtype", DTYPES)
def test_count_discard_selects_equal_the_sort(dtype):
    """Both selects at every grid case and q, against ``np.partition``."""
    for name, x in _cases(dtype):
        tx = _t(x)
        for q in QS:
            want = _t(np.asarray(oracle_quantile(x, q)).reshape(1))
            for fn in (tb.afs_select, tb.jeffers_select):
                got = fn(tx, q)
                if float(want) == 0:
                    assert float(got) == 0, (name, q, fn.__name__)
                    continue
                assert _bytes(got.reshape(1)) == _bytes(want), (
                    name, q, fn.__name__)


