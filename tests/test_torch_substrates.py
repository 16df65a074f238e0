"""The port's training substrates against the JAX package's: the data
pipeline, the loss statistics, the fault-tolerance state machines,
checkpoints of training state in both directions, and the training loop's
exact resume.

Compared as raw bits: every pipeline batch (tokens, labels, frontend
stubs) across shards, seeks and steps; ``StreamStats`` quantiles; the
hosts a ``StragglerMonitor`` flags; a checkpoint the port writes, restored
by JAX with JAX's template.  The losses of a port run resumed from a JAX
checkpoint match JAX's uninterrupted run within rtol = atol = 2e-4, the
reference's own resume bound (``tests/test_substrates.py``): the two
packages round the bf16 forward in other orders.  The port's own resume
after a restart matches its uninterrupted run within the same bound.

The cases are split over this file and ``test_torch_substrates_ckpt.py``,
so that xdist's ``--dist loadfile`` can run them on several workers; those
files import their helpers from here.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import data as JD                                  # noqa: E402
from repro import distributed as JF                           # noqa: E402
from repro_torch import data as TD                            # noqa: E402
from repro_torch import distributed as TF                     # noqa: E402

ARCH = "stablelm-1.6b"
RUN = dict(global_batch=2, seq_len=16, log_every=0, quantile_clip=0.999)

# ---------------------------------------------------------------------------
# data pipeline and statistics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("extras", [False, True])
def test_pipeline_batches_match_jax(extras):
    """``batch_at`` over shards and steps, and iteration after ``seek``,
    give JAX's arrays bit for bit (with the vision and audio stubs'
    float frontends when asked for)."""
    kw = dict(frontend_len=3, enc_seq=5, d_model=4) if extras else {}
    jcfg = JD.DataConfig(vocab=997, seq_len=16, global_batch=8, seed=7, **kw)
    tcfg = TD.DataConfig(vocab=997, seq_len=16, global_batch=8, seed=7, **kw)
    for shard in range(2):
        jp = JD.SyntheticPipeline(jcfg, shard, 2)
        tp = TD.SyntheticPipeline(tcfg, shard, 2)
        for step in (0, 1, 11, 1000):
            want, got = jp.batch_at(step), tp.batch_at(step)
            assert sorted(got) == sorted(want)
            for key in want:
                assert got[key].dtype == want[key].dtype, key
                assert np.array_equal(got[key].view(np.uint8),
                                      want[key].view(np.uint8)), key
        jp.seek(5)
        tp.seek(5)
        jit, tit = iter(jp), iter(tp)
        for _ in range(3):
            assert np.array_equal(next(tit)["tokens"], next(jit)["tokens"])
        assert tp.step == jp.step == 7
    with pytest.raises(ValueError):
        TD.SyntheticPipeline(tcfg, 0, 3)


def test_stream_stats_match_jax():
    rng = np.random.default_rng(4)
    js, ts = JD.StreamStats(eps=0.05), TD.StreamStats(eps=0.05)
    for n in (1, 7, 5000, 20_000):
        data = rng.normal(size=n)
        js.update(data)
        ts.update(data)
        for q in (0.01, 0.5, 0.9, 1.0):
            assert ts.quantile(q) == js.quantile(q)


# ---------------------------------------------------------------------------
# fault tolerance
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window", [16, None])
def test_straggler_monitor_matches_jax(window):
    """A scripted run: 8 hosts a step, a slow regime that ends (the
    windowed monitor forgets it, the all-history one does not), probes
    after every few steps; both packages flag the same hosts."""
    rng = np.random.default_rng(5)
    jm = JF.StragglerMonitor(min_samples=24, window=window)
    tm = TF.StragglerMonitor(min_samples=24, window=window, device="cpu")
    probe = {"h0": 1.0, "h1": 2.3, "h2": 3.1, "h3": 9.0}
    flagged = []
    for step in range(40):
        slow = 1.5 if 8 <= step < 20 else 1.0
        durations = {f"h{i}": float(slow + 0.02 * i + 0.01 * rng.random())
                     for i in range(8)}
        jm.record(durations)
        tm.record(durations)
        if step % 4 == 3:
            assert tm.decide(probe) == jm.decide(probe), step
            flagged.append(tm.decide(probe))
    assert len({tuple(f) for f in flagged}) > 1      # the regimes show
    tm.record({})
    assert tm.window == jm.window


def test_elastic_plans_barriers_and_preemption_match_jax():
    for alive in (16, 17, 48, 480, 511, 4096):
        for mp in (1, 8, 16):
            for batch in (64, 256, 96):
                want = JF.plan_rescale(alive, mp, batch)
                got = TF.plan_rescale(alive, mp, batch)
                assert (got.data, got.model, got.pods,
                        got.restore_from_checkpoint) == (
                    want.data, want.model, want.pods,
                    want.restore_from_checkpoint)
    with pytest.raises(RuntimeError):
        TF.plan_rescale(alive_chips=8, model_parallel=16, global_batch=64)
    jb, tb = JF.StepBarrier(2.0), TF.StepBarrier(2.0)
    for step, slowest in enumerate((5.0, 1.0, 2.0, 2.5, 0.1)):
        assert tb.check(step, slowest) == jb.check(step, slowest)
    assert tb.skipped_steps == jb.skipped_steps == [0, 3]
    ph = TF.PreemptionHandler()
    assert not ph.should_stop
    ph.preempt()
    assert ph.should_stop
