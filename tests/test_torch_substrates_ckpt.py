"""The training loops of both packages from one module run each: resume
across the packages' checkpoints, bit for bit, preemption and restore,
and the checkpoint writer's retention and atomic writes (helpers:
``test_torch_substrates.py``)."""
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
from repro.configs import get_config as jget_config           # noqa: E402
from repro.launch.train import train_loop as jtrain_loop      # noqa: E402
from repro.models import model as JM                          # noqa: E402
from repro.optim import adamw_init as jadamw_init             # noqa: E402
from repro_torch import checkpoint as TC                      # noqa: E402
from repro_torch import distributed as TF                     # noqa: E402
from repro_torch.configs import get_config                    # noqa: E402
from repro_torch.launch.train import train_loop               # noqa: E402
from repro_torch.models import model as TM                    # noqa: E402
from repro_torch.optim import AdamWState                      # noqa: E402

from test_torch_substrates import (ARCH, RUN)  # noqa: E402


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


def test_jax_restores_a_port_encdec_checkpoint_bit_for_bit(tmp_path):
    """The port's training checkpoint of reduced seamless-m4t-large-v2
    after 2 steps (its batches carry the frames), restored by JAX's
    ``restore_checkpoint`` into JAX's (params, AdamWState) template: every
    leaf, the encoder's, ``enc_norm`` and the cross leaves included, the
    port's state, bit for bit, under JAX's paths."""
    arch = "seamless-m4t-large-v2"
    out = train_loop(get_config(arch).reduced(), steps=2, global_batch=2,
                     seq_len=16, ckpt_dir=str(tmp_path), ckpt_every=100,
                     device="cpu", log_every=0)
    jparams = JM.init_params(jget_config(arch).reduced(),
                             jax.random.PRNGKey(0))
    template = (jparams, jadamw_init(jparams))
    (jp, jopt), extra = JC.restore_checkpoint(str(tmp_path), template)
    assert extra["data_step"] == 2
    opt = out["opt_state"]
    want = (jax.tree.leaves(TM.params_to_numpy(out["params"]))
            + [opt.step.numpy()]
            + jax.tree.leaves(TM.params_to_numpy(opt.m))
            + jax.tree.leaves(TM.params_to_numpy(opt.v)))
    got = jax.tree.leaves((jp, jopt))
    assert len(got) == len(want) == len(jax.tree.leaves(template))
    for g, w in zip(got, want):
        g = np.asarray(g)
        assert g.shape == w.shape and g.itemsize == w.itemsize
        assert np.array_equal(_bits(g), _bits(w))
    assert {"wq_c", "wk_c", "ln_c"} <= set(jp["dec_blocks"])
    assert not np.array_equal(_bits(jp["dec_blocks"]["wq_c"]),
                              _bits(jparams["dec_blocks"]["wq_c"]))
