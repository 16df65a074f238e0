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
from repro.launch.quantile_service import (                   # noqa: E402
    StreamingCalibrator as JCalibrator)
from repro_torch.configs import get_config                    # noqa: E402
from repro_torch.core import as_device_tensor                 # noqa: E402
from repro_torch.launch import StreamingCalibrator            # noqa: E402
from repro_torch.launch import serve as TS                    # noqa: E402
from repro_torch.models import model as TM                    # noqa: E402

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


class _Tap(StreamingCalibrator):
    """A calibrator that also keeps a host copy of what it observes."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.seen = []

    def observe_many(self, named):
        self.seen.append({k: v.numpy().copy() for k, v in named.items()})
        super().observe_many(named)


@pytest.fixture(scope="module")
def served():
    cfg = get_config("granite-8b").reduced()
    params = TM.init_params(cfg, 0, device="cpu")
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 12), dtype=np.int32))
    return cfg, params, prompts


def _close(cal, limit=LIMIT_S):
    cal.close()
    if cal.pool is not None:
        threads = cal.pool._threads + [cal.pool._fold_thread]
        for t in threads:
            t.join(timeout=limit)
        assert not any(t.is_alive() for t in threads)


@pytest.mark.parametrize("threads", [0, 1, 2])
@pytest.mark.parametrize("fused", [False, True])
def test_generate_with_streaming_calibrator_matches_jax(served, fused,
                                                        threads):
    cfg, params, prompts = served
    cal = _Tap(Q, fused=fused, ingest_threads=threads, device="cpu")
    toks = TS.generate(cfg, params, prompts, gen_len=GEN, calibrator=cal)
    assert toks.shape == (2, GEN) and len(cal.seen) == GEN
    assert torch.equal(toks, TS.generate(cfg, params, prompts, gen_len=GEN))
    jcal = JCalibrator(Q, fused=fused, ingest_threads=threads)
    for step in cal.seen:
        jcal.observe_many({k: jnp.asarray(v) for k, v in step.items()})
    try:
        got, want = cal.scale("logits"), jcal.scale("logits")
        assert tb(got) == jb(want)
        n = cal.observed("logits")
        assert n == jcal.observed("logits") == GEN * 2 * cfg.vocab
        everything = np.concatenate([s["logits"].ravel() for s in cal.seen])
        k = math.ceil(Q * n)
        assert tb(got) == np.sort(np.abs(everything))[k - 1].tobytes()
        approx = cal.approx_scale("logits")
        if threads < 2:
            assert tb(approx) == jb(jcal.approx_scale("logits"))
        else:
            srt = np.sort(np.abs(everything))
            lo = np.searchsorted(srt, float(approx), "left") + 1
            hi = np.searchsorted(srt, float(approx), "right")
            bound = cal.service.rank_bound("logits")
            assert lo - bound <= k <= hi + bound
    finally:
        _close(cal)
        jcal.close()


def test_main_runs_on_the_cpu(capsys):
    TS.main(["--arch", "granite-8b", "--reduced", "--device", "cpu",
             "--calibrate", "--ingest-threads", "2"])
    out = capsys.readouterr().out
    assert "tok/s" in out
    assert "streaming calibration (threaded x2)" in out
    assert f"{4 * 16 * 256} |logit| samples" in out
    assert "exact p99.9 scale (warm)" in out and "approx O(s)" in out
