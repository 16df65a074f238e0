"""A reduced zamba2-2.7b training checkpoint crossing both packages, and
the serve CLI on the ssm and hybrid families (helpers:
``test_torch_ssm.py``)."""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402
from repro.checkpoint import checkpoint as JC                 # noqa: E402
from repro.models import model as JM                          # noqa: E402
from repro.optim.adamw import adamw_init as jadamw_init       # noqa: E402
from repro_torch import pytree                                # noqa: E402
from repro_torch.checkpoint import checkpoint as TC           # noqa: E402
from repro_torch.launch.train import _state_tree, train_loop  # noqa: E402
from repro_torch.models import model as TM                    # noqa: E402
from repro_torch.optim.adamw import AdamWState, adamw_init    # noqa: E402

from test_torch_ssm import (ARCHS, REPO, _bits, _cfgs)  # noqa: E402


def test_hybrid_checkpoint_crosses_both_packages(tmp_path):
    """The port's training checkpoint of reduced zamba2-2.7b (2 steps),
    restored by JAX into its (params, AdamWState) template, leaf for leaf
    under JAX's paths (``mamba/in_proj``, ``shared/wq``, ...), bit for
    bit; and a JAX checkpoint of its own initial state restored by the
    port, bit for bit."""
    jcfg, cfg = _cfgs("zamba2-2.7b")
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
    assert {"in_proj", "A_log"} <= set(jp["mamba"]) and "wq" in jp["shared"]

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
    TM.load_params(tp, p_st)
    np.testing.assert_array_equal(
        _bits(tp.mamba[0][1].p["in_proj"].detach().numpy()),
        _bits(jparams["mamba"]["in_proj"][0, 1]))


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_on_the_cpu(arch):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         "--reduced", "--device", "cpu", "--calibrate"], env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "generated (4, 16)" in proc.stdout
    assert "exact p99.9 scale" in proc.stdout
