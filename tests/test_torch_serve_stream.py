"""``generate`` with a ``StreamingCalibrator`` (fused or plain, synchronous
or threaded) against the JAX package's, bit for bit, and the serve CLI
(helpers: ``test_torch_serve.py``)."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                       # noqa: E402
from repro.launch.quantile_service import (                   # noqa: E402
    StreamingCalibrator as JCalibrator)
from repro_torch.configs import get_config                    # noqa: E402
from repro_torch.launch import StreamingCalibrator            # noqa: E402
from repro_torch.launch import serve as TS                    # noqa: E402
from repro_torch.models import model as TM                    # noqa: E402

from test_torch_serve import (GEN, LIMIT_S, Q, jb, tb)  # noqa: E402


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
