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
"""
import dataclasses
import json
import os
import shutil
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402

from repro import checkpoint as JC                            # noqa: E402
from repro import data as JD                                  # noqa: E402
from repro import distributed as JF                           # noqa: E402
from repro.configs import get_config as jget_config           # noqa: E402
from repro.launch.train import train_loop as jtrain_loop      # noqa: E402
from repro.models import model as JM                          # noqa: E402
from repro.optim import adamw_init as jadamw_init             # noqa: E402
from repro_torch import checkpoint as TC                      # noqa: E402
from repro_torch import data as TD                            # noqa: E402
from repro_torch import distributed as TF                     # noqa: E402
from repro_torch.configs import get_config                    # noqa: E402
from repro_torch.launch.train import train_loop               # noqa: E402
from repro_torch.models import model as TM                    # noqa: E402
from repro_torch.optim import AdamWState                      # noqa: E402

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


# ---------------------------------------------------------------------------
# checkpoints and the training loop
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX and the port, each 6 steps uninterrupted and 3 steps that
    checkpoint, on reduced stablelm-1.6b."""
    root = tmp_path_factory.mktemp("train")
    jcfg = jget_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    out = {"jcfg": jcfg, "cfg": cfg, "jax_dir": str(root / "jax"),
           "port_dir": str(root / "port")}
    out["jax_full"] = jtrain_loop(jcfg, steps=6, **RUN)
    out["jax_partial"] = jtrain_loop(jcfg, steps=3, ckpt_dir=out["jax_dir"],
                                     ckpt_every=100, **RUN)
    out["port_full"] = train_loop(cfg, steps=6, device="cpu", **RUN)
    out["port_partial"] = train_loop(cfg, steps=3, ckpt_dir=out["port_dir"],
                                     ckpt_every=100, device="cpu", **RUN)
    return out


def _copy(src, tmp_path):
    dst = str(tmp_path / "ckpt")
    shutil.copytree(src, dst)
    return dst


def test_port_resumes_a_jax_checkpoint(runs, tmp_path):
    """JAX's 3 steps, then the port's train_loop from JAX's checkpoint to
    step 6: the loss trajectory of JAX's uninterrupted run."""
    resumed = train_loop(runs["cfg"], steps=6,
                         ckpt_dir=_copy(runs["jax_dir"], tmp_path),
                         ckpt_every=100, device="cpu", **RUN)
    assert resumed["final_step"] == 6
    got = runs["jax_partial"]["losses"] + resumed["losses"]
    assert np.allclose(got, runs["jax_full"]["losses"], rtol=2e-4,
                       atol=2e-4), (got, runs["jax_full"]["losses"])


def _bits(a):
    a = np.asarray(a)
    return a.view({1: np.int8, 2: np.int16, 4: np.int32, 8: np.int64}[
        a.itemsize])


def test_jax_restores_a_port_checkpoint_bit_for_bit(runs):
    """The port's checkpoint after 3 steps, restored by JAX's
    ``restore_checkpoint`` into JAX's (params, AdamWState) template: every
    leaf the port's state, bit for bit, under JAX's paths."""
    jcfg = runs["jcfg"]
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    template = (jparams, jadamw_init(jparams))
    (jp, jopt), extra = JC.restore_checkpoint(runs["port_dir"], template)
    assert extra["data_step"] == 3
    part = runs["port_partial"]
    opt = part["opt_state"]
    want = (jax.tree.leaves(TM.params_to_numpy(part["params"]))
            + [opt.step.numpy()]
            + jax.tree.leaves(TM.params_to_numpy(opt.m))
            + jax.tree.leaves(TM.params_to_numpy(opt.v)))
    got = jax.tree.leaves((jp, jopt))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = np.asarray(g)
        assert g.shape == w.shape and g.itemsize == w.itemsize
        assert np.array_equal(_bits(g), _bits(w))
    with open(os.path.join(runs["port_dir"], "step_0000000003",
                           "manifest.json")) as f:
        paths = json.load(f)["paths"]
    assert paths == [jax.tree_util.keystr(kp) for kp, _ in
                     jax.tree_util.tree_flatten_with_path(template)[0]]


def _tbits(t):
    return t.contiguous().view({1: torch.int8, 2: torch.int16,
                                4: torch.int32, 8: torch.int64}[
                                    t.element_size()])


def test_restore_checkpoint_gives_the_saved_state(runs):
    """The port's own restore, into a template of meta tensors, on the
    CPU: the state it saved, bit for bit."""
    part = runs["port_partial"]
    tree = TM.param_tree(part["params"])
    opt = part["opt_state"]
    saved = (TM.stacked(tree), AdamWState(opt.step, TM.stacked(opt.m),
                                          TM.stacked(opt.v)))
    template = jax.tree.map(lambda t: t.to("meta"), saved,
                            is_leaf=lambda t: isinstance(t, torch.Tensor))
    restored, extra = TC.restore_checkpoint(runs["port_dir"], saved,
                                            device="cpu")
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(saved)):
        assert a.dtype == b.dtype and a.device.type == "cpu"
        assert torch.equal(_tbits(a), _tbits(b))
    assert isinstance(restored[1], AdamWState)
    assert extra["data_step"] == 3
    meta, _ = TC.restore_checkpoint(runs["port_dir"], template,
                                    device="cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(jax.tree.leaves(meta), jax.tree.leaves(restored)))


def test_resume_after_preemption_same_trajectory(runs, tmp_path):
    """The reference's resume test on the port: 3 steps that checkpoint,
    then a restart to step 6, against an uninterrupted run."""
    resumed = train_loop(runs["cfg"], steps=6,
                         ckpt_dir=_copy(runs["port_dir"], tmp_path),
                         ckpt_every=100, device="cpu", **RUN)
    got = runs["port_partial"]["losses"] + resumed["losses"]
    assert np.allclose(got, runs["port_full"]["losses"], rtol=2e-4,
                       atol=2e-4), (got, runs["port_full"]["losses"])


def test_preemption_checkpoints_at_the_step_boundary(runs, tmp_path):
    """A preemption flagged before the first step: the loop runs that step,
    checkpoints it and stops."""
    ph = TF.PreemptionHandler()
    ph.preempt()
    d = str(tmp_path / "ckpt")
    out = train_loop(runs["cfg"], steps=6, ckpt_dir=d, preemption=ph,
                     device="cpu", **RUN)
    assert out["final_step"] == 1 and len(out["losses"]) == 1
    assert out["losses"][0] == runs["port_full"]["losses"][0]
    assert TC.latest_step(d) == 1


def test_structure_mismatch_is_refused(runs):
    """A template with another leaf count or another leaf shape raises,
    in both packages' checkpoints."""
    part = runs["port_partial"]
    tree = TM.stacked(TM.param_tree(part["params"]))
    for directory in (runs["port_dir"], runs["jax_dir"]):
        with pytest.raises(ValueError, match="structure"):
            TC.restore_checkpoint(directory, tree, device="cpu")
    other = TM.init_params(dataclasses.replace(runs["cfg"], d_ff=128), 0,
                           device="cpu")
    opt = part["opt_state"]
    template = (TM.stacked(TM.param_tree(other)),
                AdamWState(opt.step, TM.stacked(TM.param_tree(other)),
                           TM.stacked(TM.param_tree(other))))
    with pytest.raises(ValueError, match="shape"):
        TC.restore_checkpoint(runs["port_dir"], template, device="cpu")


def test_roundtrip_retention_and_atomic_writes():
    """The reference's checkpoint tests on the port: retention keeps the
    newest two, the restore gives the tree and the extra back, and no
    temporary directory is left behind."""
    tree = {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.ones(5, dtype=torch.int32)},
            "d": torch.arange(4.0).to(torch.bfloat16)}
    with tempfile.TemporaryDirectory() as d:
        for s in range(1, 5):
            TC.save_checkpoint(d, s, tree, extra={"data_step": s * 10},
                               keep=2)
        assert TC.latest_step(d) == 4
        entries = os.listdir(d)
        assert sorted(entries) == ["step_0000000003", "step_0000000004"]
        restored, extra = TC.restore_checkpoint(d, tree, device="cpu")
        assert extra["data_step"] == 40
        for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(tree)):
            assert a.dtype == b.dtype and torch.equal(a, b)
        jrestored, _ = JC.restore_checkpoint(
            d, jax.tree.map(lambda t: np.zeros(t.shape, np.float32)
                            if t.dtype != torch.int32 else
                            np.zeros(t.shape, np.int32), tree))
        assert np.array_equal(np.asarray(jrestored["d"]), np.arange(4.0))
    with pytest.raises(FileNotFoundError):
        TC.restore_checkpoint(d, tree, device="cpu")
