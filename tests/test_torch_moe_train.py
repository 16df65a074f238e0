"""The moe family's ``forward_loss`` and every gradient against
``jax.value_and_grad``, the ``dots`` policy, ``init_params``, a moe
checkpoint crossing both packages and the serve and train CLIs (helpers
and tolerances: ``test_torch_moe.py``)."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode    # noqa: E402
from repro.checkpoint import checkpoint as JC                 # noqa: E402
from repro.models import model as JM                          # noqa: E402
from repro.optim.adamw import adamw_init as jadamw_init       # noqa: E402
from repro_torch import pytree                                # noqa: E402
from repro_torch.checkpoint import checkpoint as TC           # noqa: E402
from repro_torch.configs import get_config                    # noqa: E402
from repro_torch.launch.train import _state_tree, train_loop  # noqa: E402
from repro_torch.models import model as TM                    # noqa: E402
from repro_torch.optim.adamw import AdamWState, adamw_init    # noqa: E402

from test_torch_moe import (ARCHS, B, GRAD_TOL, LOSS_TOL, REPO, _cfgs,
    _models, _rel, _t)


def _batch(cfg, n, seed):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, (B, n + 1),
                                                dtype=np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :5] = -1
    return {"tokens": toks[:, :-1], "labels": labels}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_grads_match_jax(arch, dtype):
    """``forward_loss`` at S = 24 (the load-balance loss at 0.01 / layer
    in the total), its metrics, and every parameter's gradient (the
    router's and the experts' included) against ``jax.value_and_grad``."""
    jcfg, jp, tp = _models(arch, dtype, seed=7)
    cfg = tp.cfg
    batch = _batch(cfg, 24, seed=8)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: JM.forward_loss(p, b, jcfg), has_aux=True))(jp, batch)
    tp.requires_grad_(True)
    tl, tm = TM.forward_loss(tp, {k: _t(v) for k, v in batch.items()}, cfg)
    tl.backward()
    assert abs(float(tl.detach()) - float(jl)) <= LOSS_TOL[dtype] * abs(float(jl))
    aux = float(tm["aux"].detach())
    assert aux == pytest.approx(float(jm["aux"]), rel=LOSS_TOL[dtype])
    assert aux > 0
    assert float(tl.detach()) == pytest.approx(
        float(tm["ce"].detach()) + 0.01 * aux / cfg.n_layers, rel=1e-6)
    assert int(tm["tokens"]) == int(jm["tokens"]) == 2 * 24 - 5
    grads = TM.params_to_numpy(pytree.tree_map(lambda p: p.grad,
                                               TM.param_tree(tp)))
    assert jax.tree.structure(grads) == jax.tree.structure(jg)
    for path, got, want in zip(pytree.paths(grads), jax.tree.leaves(grads),
                               jax.tree.leaves(jg)):
        assert got.shape == want.shape, path
        assert _rel(got, want) <= GRAD_TOL[dtype], path


class _CountMatmuls(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = self.bmm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.mm += 1
        elif func == torch.ops.aten.bmm.default:
            self.bmm += 1
        return func(*args, **(kwargs or {}))


def test_dots_policy_saves_no_bmm():
    """Under ``remat="dots"`` the backward reruns no ``mm`` (the
    projections, the router, the dense residual: their outputs are kept)
    but reruns the batched products, the experts' three among them, as
    JAX's ``dots_with_no_batch_dims_saveable``; the gradients are the
    bits of ``remat="none"``."""
    base = get_config("arctic-480b").reduced()
    batch = {k: _t(v) for k, v in _batch(base, 24, seed=9).items()}
    seen = {}
    for remat in ("none", "dots"):
        cfg = dataclasses.replace(base, remat=remat, param_dtype="float32")
        tp = TM.init_params(cfg, 5, device="cpu").requires_grad_(True)
        loss, _ = TM.forward_loss(tp, batch, cfg)
        with _CountMatmuls() as counter:
            loss.backward()
        grads = [p.grad for p in pytree.leaves(TM.param_tree(tp))]
        seen[remat] = (loss.detach(), grads, counter)
    (l0, g0, c0), (l1, g1, c1) = seen["none"], seen["dots"]
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert c1.mm == c0.mm
    assert c1.bmm >= c0.bmm + 3 * base.n_layers


def test_init_params_moe_shapes_and_scales():
    cfg = get_config("arctic-480b").reduced()
    a = TM.init_params(cfg, 0, device="cpu")
    p = a.blocks[0].p
    E, D, F = cfg.moe_experts, cfg.d_model, cfg.d_ff
    assert p["router"].shape == (D, E) and p["router"].dtype == torch.float32
    assert p["we_gate"].shape == (E, D, F) and p["we_down"].shape == (E, F, D)
    assert p["we_up"].dtype == torch.bfloat16
    assert p["w_gate"].shape == (D, F)             # the dense residual
    assert "w_gate" not in TM.init_params(
        get_config("olmoe-1b-7b").reduced(), 0, device="cpu").blocks[0].p
    so = 0.02 / (2 * cfg.n_layers) ** 0.5
    assert abs(float(p["we_down"].float().std()) - so) < 0.1 * so
    assert abs(float(p["router"].std()) - 0.02) < 2e-3
    n = sum(w.numel() for w in a.parameters())
    assert n == cfg.param_count() + cfg.d_model     # + final_norm


def _bits(a):
    a = np.asarray(a)
    return a.view({1: np.int8, 2: np.int16, 4: np.int32, 8: np.int64}[
        a.itemsize])


def test_moe_checkpoint_crosses_both_packages(tmp_path):
    """The port's training checkpoint of reduced olmoe-1b-7b (2 steps),
    restored by JAX into its (params, AdamWState) template, leaf for leaf
    under JAX's paths (``blocks/router``, ``blocks/we_gate``, ...), bit for
    bit; and a JAX checkpoint of its own initial state restored by the
    port into its template, bit for bit."""
    jcfg, cfg = _cfgs("olmoe-1b-7b")
    port_dir = str(tmp_path / "port")
    out = train_loop(cfg, steps=2, global_batch=2, seq_len=16,
                     ckpt_dir=port_dir, ckpt_every=100, device="cpu",
                     log_every=0)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    (jp, jopt), extra = JC.restore_checkpoint(
        port_dir, (jparams, jadamw_init(jparams)))
    assert extra["data_step"] == 2
    opt = out["opt_state"]
    want = (jax.tree.leaves(TM.params_to_numpy(out["params"]))
            + [opt.step.numpy()]
            + jax.tree.leaves(TM.params_to_numpy(opt.m))
            + jax.tree.leaves(TM.params_to_numpy(opt.v)))
    got = jax.tree.leaves((jp, jopt))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.asarray(g).shape == w.shape
        assert np.array_equal(_bits(g), _bits(w))
    assert "blocks" in jp and {"router", "we_gate", "we_up", "we_down"} <= \
        set(jp["blocks"])

    jax_dir = str(tmp_path / "jax")
    jstate = (jparams, jadamw_init(jparams))
    JC.save_checkpoint(jax_dir, 1, jstate, extra={"data_step": 1})
    tp = TM.init_params(cfg, 1, device="cpu")
    tree = TM.param_tree(tp)
    template = _state_tree(tree, adamw_init(tree), "meta")
    (p_st, o_st), _ = TC.restore_checkpoint(jax_dir, template, device="cpu")
    assert isinstance(o_st, AdamWState)
    got = pytree.leaves((p_st, o_st))
    assert len(got) == len(jax.tree.leaves(jstate))
    for g, w in zip(got, jax.tree.leaves(jstate)):
        g = g.view(torch.int16) if g.dtype == torch.bfloat16 else g
        assert np.array_equal(_bits(g.numpy()), _bits(w))


def _run(module, *args):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-m", module, *args], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def test_serve_and_train_clis_run_olmoe_on_the_cpu():
    out = _run("repro_torch.launch.serve", "--arch", "olmoe-1b-7b",
               "--reduced", "--device", "cpu", "--calibrate")
    assert "generated (4, 16)" in out and "exact p99.9 scale" in out
    out = _run("repro_torch.launch.train", "--arch", "olmoe-1b-7b",
               "--reduced", "--device", "cpu", "--steps", "3",
               "--global-batch", "2", "--seq-len", "16")
    assert "done: 3 steps" in out
