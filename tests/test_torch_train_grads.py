"""The port's dense ``forward_loss`` and every gradient against
``jax.value_and_grad``, the remat policies, the gradients' way back to
JAX's layout, and the train CLI (helpers and tolerances:
``test_torch_train.py``)."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode    # noqa: E402
from repro.configs import get_config as jget_config           # noqa: E402
from repro.models import model as JM                          # noqa: E402
from repro_torch import pytree                                # noqa: E402
from repro_torch.configs import get_config                    # noqa: E402
from repro_torch.models import model as TM                    # noqa: E402

from test_torch_train import (ARCHS, GRAD_TOL, LOSS_TOL, REPO, _rel,
    _t)


def _cfgs(arch, dtype):
    return (dataclasses.replace(jget_config(arch).reduced(), param_dtype=dtype),
            dataclasses.replace(get_config(arch).reduced(), param_dtype=dtype))


def _batch(cfg, S, seed):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab, (2, S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :5] = -1
    return {"tokens": toks[:, :-1], "labels": labels}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_grads_match_jax(arch, dtype):
    """``forward_loss`` at S = 48 (the blockwise attention at the reduced
    blocks of 16 and 32), its metrics, and every parameter's gradient
    against ``jax.value_and_grad`` of the reference's."""
    jcfg, cfg = _cfgs(arch, dtype)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(1))
    tp = TM.params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                              device="cpu")
    batch = _batch(cfg, 48, seed=2)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: JM.forward_loss(p, b, jcfg), has_aux=True))(jp, batch)
    tp.requires_grad_(True)
    tl, tm = TM.forward_loss(tp, {k: _t(v) for k, v in batch.items()}, cfg)
    tl.backward()
    assert abs(float(tl.detach()) - float(jl)) <= LOSS_TOL[dtype] * abs(float(jl))
    assert int(tm["tokens"]) == int(jm["tokens"]) == 2 * 48 - 5
    assert float(tm["aux"]) == float(jm["aux"]) == 0.0
    grads = TM.params_to_numpy(pytree.tree_map(lambda p: p.grad,
                                               TM.param_tree(tp)))
    assert jax.tree.structure(grads) == jax.tree.structure(jg)
    for path, got, want in zip(pytree.paths(grads), jax.tree.leaves(grads),
                               jax.tree.leaves(jg)):
        assert got.shape == want.shape, path
        assert _rel(got, want) <= GRAD_TOL[dtype], path


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.mm += 1
        return func(*args, **(kwargs or {}))


def test_remat_policies_give_the_same_gradients():
    """``none``, ``nothing_saveable`` and ``dots`` give the same loss and
    gradient bits.  The backward of ``nothing_saveable`` reruns the
    blocks' projection and MLP matmuls (6 of the 7 a layer: the recompute
    stops once it has what the backward saved, before ``w_down``);
    ``dots`` keeps their outputs and reruns none of them."""
    base = get_config("stablelm-1.6b").reduced()
    batch = {k: _t(v) for k, v in _batch(base, 48, seed=4).items()}
    seen = {}
    for remat in ("none", "nothing_saveable", "dots"):
        cfg = dataclasses.replace(base, remat=remat, param_dtype="float32")
        tp = TM.init_params(cfg, 5, device="cpu").requires_grad_(True)
        loss, _ = TM.forward_loss(tp, batch, cfg)
        with _CountMM() as counter:
            loss.backward()
        grads = [p.grad for p in pytree.leaves(TM.param_tree(tp))]
        seen[remat] = (loss.detach(), grads, counter.mm)
    want_loss, want_grads, mm = seen["none"]
    for remat in ("nothing_saveable", "dots"):
        loss, grads, _ = seen[remat]
        assert torch.equal(loss, want_loss), remat
        assert all(torch.equal(a, b) for a, b in zip(grads, want_grads))
    assert seen["nothing_saveable"][2] == mm + 6 * base.n_layers
    assert seen["dots"][2] == mm


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_to_numpy_inverts_params_from_numpy(dtype):
    """JAX's tree goes in and comes out with the same structure, shapes
    and bits; ``stacked`` and ``unstacked`` undo each other."""
    jcfg, cfg = _cfgs("stablelm-1.6b", dtype)
    jp = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(7)))
    tp = TM.params_from_numpy(cfg, jp, device="cpu")
    back = TM.params_to_numpy(tp)
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        if want.dtype.name == "bfloat16":
            want = want.view(np.uint16)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    again = TM.params_to_numpy(TM.params_from_numpy(cfg, back, device="cpu"))
    assert all(np.array_equal(a, b) for a, b in
               zip(jax.tree.leaves(again), jax.tree.leaves(back)))
    tree = TM.param_tree(tp)
    round_trip = TM.unstacked(TM.stacked(tree))
    assert all(torch.equal(a, b) for a, b in
               zip(pytree.leaves(round_trip), pytree.leaves(tree)))


def test_train_cli_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "stablelm-1.6b", "--reduced", "--device", "cpu", "--steps", "3",
         "--global-batch", "2", "--seq-len", "16"],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "done: 3 steps" in proc.stdout
