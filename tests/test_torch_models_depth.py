"""The bf16 decode gap at granite-8b's depth in both packages, the port's
``init_params`` and ``params_from_numpy``, and the shapes of the
encoder-decoder's weights and cache (helpers and tolerances:
``test_torch_models.py``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402
from repro_torch.configs import get_config                    # noqa: E402
from repro_torch.models import model as TM                    # noqa: E402

from test_torch_models import (_models)  # noqa: E402


def test_bf16_decode_gap_at_depth_is_the_reference_s():
    """With bf16 weights, decode after prefill(S) parts from prefill(S + 1)
    by the rounding of every layer's matmuls and residual, which grows with
    depth and width: at granite-8b's 36 layers and d_model 256 both
    packages are already past 1e-2 of the logit scale.  The port's gap
    stays within a factor 1.5 of JAX's on the same weights, and in both
    packages the decode is no farther (at most 1.5 x) from an f32
    evaluation of the same weights than the prefill is: the gap is the
    bf16 model's own, not the decode's.  ``tests/_decode_gap.py`` runs the
    same at wider widths."""
    from _decode_gap import gaps

    got = gaps(256, n_heads=4, n_kv_heads=1, d_head=64, d_ff=896)
    jax_, port = got["jax"], got["port"]
    assert jax_["gap"] > 1e-2
    assert jax_["gap"] / 1.5 <= port["gap"] <= 1.5 * jax_["gap"], got
    for side in (jax_, port):
        assert side["decode_vs_f32"] <= 1.5 * side["prefill_vs_f32"], got


def test_init_params_is_seeded_with_the_reference_scales():
    cfg = get_config("granite-8b").reduced()
    a = TM.init_params(cfg, 0, device="cpu")
    b = TM.init_params(cfg, 0, device="cpu")
    c = TM.init_params(cfg, 1, device="cpu")
    assert torch.equal(a.p["embed"], b.p["embed"])
    assert not torch.equal(a.p["embed"], c.p["embed"])
    assert a.p["embed"].dtype == torch.bfloat16
    assert a.blocks[0].p["ln1"].dtype == torch.float32
    assert (a.blocks[1].p["ln2"] == 1).all() and len(a.blocks) == cfg.n_layers
    so = 0.02 / (2 * cfg.n_layers) ** 0.5
    assert abs(float(a.p["head"].float().std()) - 0.02) < 2e-3
    assert abs(float(a.blocks[0].p["wo"].float().std()) - so) < 0.1 * so
    n = sum(p.numel() for p in a.parameters())
    assert n == cfg.param_count() + cfg.d_model     # + final_norm


def test_params_from_numpy_is_bit_exact_and_takes_uint16_bits():
    jcfg, jp, tp = _models("stablelm-1.6b", "bfloat16", seed=11)
    tree = jax.tree.map(np.asarray, jp)
    bits = jax.tree.map(lambda a: a.view(np.uint16)
                        if a.dtype.name == "bfloat16" else a, tree)
    tp2 = TM.params_from_numpy(tp.cfg, bits, device="cpu")
    for (name, a), (_, b) in zip(tp.named_parameters(),
                                 tp2.named_parameters()):
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                           else a, b.view(torch.int16)
                           if b.dtype == torch.bfloat16 else b), name
    np.testing.assert_array_equal(
        tp.blocks[1].p["wq"].view(torch.int16).numpy(),
        tree["blocks"]["wq"][1].view(np.int16))
    with pytest.raises(ValueError):
        TM.params_from_numpy(tp.cfg, {"embed": tree["embed"]}, device="cpu")


@pytest.mark.parametrize("build", ["Transformer", "init_params",
                                   "init_cache"])
def test_audio_family_builds_the_reference_shapes(build):
    """The encoder-decoder (reduced seamless-m4t-large-v2): ``Transformer``
    and ``init_params`` give the leaves of JAX's ``init_params`` and
    ``init_cache(enc_len=)`` those of JAX's ``init_cache``, under the same
    paths, with the same shapes and dtypes (``jax.eval_shape``)."""
    from repro.configs import get_config as jget_config
    from repro.models import model as JM
    from repro_torch import pytree

    cfg = get_config("seamless-m4t-large-v2").reduced()
    jcfg = jget_config("seamless-m4t-large-v2").reduced()
    if build == "init_cache":
        got = TM.init_cache(cfg, 2, 8, enc_len=5, device="cpu")
        want = jax.eval_shape(lambda: JM.init_cache(jcfg, 2, 8, enc_len=5))
    else:
        made = (TM.Transformer(cfg, device="cpu") if build == "Transformer"
                else TM.init_params(cfg, 0, device="cpu"))
        got = TM.stacked(TM.param_tree(made))
        want = jax.eval_shape(lambda: JM.init_params(jcfg,
                                                     jax.random.PRNGKey(0)))
    assert pytree.paths(got) == [jax.tree_util.keystr(k) for k, _ in
                                 jax.tree_util.tree_leaves_with_path(want)]
    for path, t, a in zip(pytree.paths(got), pytree.leaves(got),
                          jax.tree.leaves(want)):
        assert tuple(t.shape) == a.shape, path
        assert str(t.dtype).split(".")[-1] == a.dtype.name, path
