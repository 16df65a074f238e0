"""The whole training loop of the vlm, audio, ssm, hybrid and moe families
against the JAX package's: ``train_loop`` for 3 steps of each reduced
config (qwen2-vl-2b, seamless-m4t-large-v2, mamba2-1.3b, zamba2-2.7b,
olmoe-1b-7b) at B = 2, S = 16, with the patches or frames the pipeline
gives, AdamW with the exact 0.999 clip.

Both loops start from JAX's ``init_params`` at the seed: the port's
restores them from a JAX checkpoint of step 0 (the resume path of its
``train_loop``).  The losses agree within rtol = atol = 2e-4, the bound
``test_torch_substrates_ckpt.py`` holds stablelm-1.6b to: the two
packages round the bf16 forward in other orders.

The ssm and hybrid cases are in ``test_torch_family_train_ssm.py``, so
that xdist's ``--dist loadfile`` can run the two files on two workers; it
imports ``check_train_loop`` from here.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402
from repro import checkpoint as JC                            # noqa: E402
from repro.configs import get_config as jget_config           # noqa: E402
from repro.launch.train import train_loop as jtrain_loop      # noqa: E402
from repro.models import model as JM                          # noqa: E402
from repro.optim import adamw_init as jadamw_init             # noqa: E402
from repro_torch.configs import get_config                    # noqa: E402
from repro_torch.launch.train import train_loop               # noqa: E402

ARCHS = ("qwen2-vl-2b", "seamless-m4t-large-v2", "olmoe-1b-7b")
SEED = 0
RUN = dict(global_batch=2, seq_len=16, log_every=0, quantile_clip=0.999,
           seed=SEED)
STEPS = 3


def check_train_loop(arch: str, tmp_path) -> None:
    """The port's and JAX's ``train_loop`` on reduced ``arch`` from JAX's
    weights: the same losses within rtol = atol = 2e-4."""
    jcfg = jget_config(arch).reduced()
    cfg = get_config(arch).reduced()
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(SEED))
    ckpt = str(tmp_path / "ckpt")
    JC.save_checkpoint(ckpt, 0, (jparams, jadamw_init(jparams)),
                       extra={"data_step": 0})
    want = jtrain_loop(jcfg, steps=STEPS, **RUN)["losses"]
    got = train_loop(cfg, steps=STEPS, ckpt_dir=ckpt, ckpt_every=100,
                     device="cpu", **RUN)
    assert got["final_step"] == STEPS
    assert np.all(np.isfinite(got["losses"]))
    assert np.allclose(got["losses"], want, rtol=2e-4, atol=2e-4), (
        got["losses"], want)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loop_losses_match_jax(arch, tmp_path):
    check_train_loop(arch, tmp_path)


@pytest.mark.parametrize("arch", ("zamba2-2.7b", "seamless-m4t-large-v2"))
def test_by_stacked_leaf_groups_layers_as_the_reference_stacks_them(arch):
    """``model.by_stacked_leaf`` (which groups the train phases' per-layer
    gradient gaps) keys each group by a leaf path of JAX's ``init_params``
    and lists its layers in the order ``stacked`` stacks them."""
    from repro_torch import pytree
    from repro_torch.models import model

    cfg = get_config(arch).reduced()
    tree = model.param_tree(model.Transformer(cfg, device="cpu"))
    filled = pytree.unflatten(tree, [torch.full_like(w, float(i)) for i, w
                                     in enumerate(pytree.leaves(tree))])
    got = model.by_stacked_leaf(tree, range(len(pytree.leaves(tree))))
    shapes = jax.eval_shape(
        lambda: JM.init_params(jget_config(arch).reduced(),
                               jax.random.PRNGKey(SEED)))
    assert list(got) == [jax.tree_util.keystr(p) for p, _ in
                         jax.tree_util.tree_flatten_with_path(shapes)[0]]
    stacked = model.stacked(filled)
    for path, leaf in zip(pytree.paths(stacked), pytree.leaves(stacked)):
        assert got[path] == leaf.reshape(len(got[path]), -1)[:, 0].tolist()
    assert sorted(v for vs in got.values() for v in vs) == list(
        range(len(pytree.leaves(tree))))
