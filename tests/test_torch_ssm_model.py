"""Reduced mamba2-1.3b and zamba2-2.7b in the port against the JAX
package's: prefill, decode and every cache leaf, ``forward_loss`` and
every gradient, and ``init_params`` (models, helpers and tolerances:
``test_torch_ssm.py``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402
from repro.models import model as JM                          # noqa: E402
from repro_torch import pytree                                # noqa: E402
from repro_torch.configs import get_config                    # noqa: E402
from repro_torch.models import model as TM                    # noqa: E402

from test_torch_ssm import (ARCHS, B, DTYPES, GRAD_TOL, LOSS_TOL, S,
    TOL, _models, _np, _rel, _shared_models, _t)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch, dtype):
    """Prefill of S = 20 into a cache of 26, then 3 decode steps; logits
    and every cache leaf each step (positions exactly)."""
    jcfg, jp, tp = _shared_models(arch, dtype)
    cfg, C = tp.cfg, S + 6
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (B, S + 3),
                                             dtype=np.int32)
    jl, jc = jax.jit(lambda p, t: JM.prefill(p, {"tokens": t}, jcfg,
                                             cache_len=C))(jp, toks[:, :S])
    tl, tc = TM.prefill(tp, {"tokens": _t(toks[:, :S])}, cfg, cache_len=C)
    assert tl.dtype == torch.float32 and tl.shape == (B, cfg.vocab)
    assert _rel(tl.numpy(), jl) <= TOL[dtype]
    decode = jax.jit(lambda p, t, c, n: JM.decode_step(p, t, c, n, jcfg))
    for i in range(4):
        assert pytree.paths(tc) == [jax.tree_util.keystr(k) for k, _ in
                                    jax.tree_util.tree_leaves_with_path(jc)]
        for path, got, want in zip(pytree.paths(tc), pytree.leaves(tc),
                                   jax.tree.leaves(jc)):
            assert tuple(got.shape) == want.shape, path
            if got.dtype == torch.int32:
                np.testing.assert_array_equal(got.numpy(), want)
            else:
                assert _rel(_np(got), want) <= TOL[dtype], (i, path)
        if i == 3:
            break
        n = np.full((B,), S + i, np.int32)
        tok = toks[:, S + i:S + i + 1]
        jl, jc = decode(jp, tok, jc, n)
        tl, tc = TM.decode_step(tp, _t(tok), tc, _t(n), cfg)
        assert _rel(tl.numpy(), jl) <= TOL[dtype], i


def _batch(cfg, n, seed):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, (B, n + 1),
                                                dtype=np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :5] = -1
    return {"tokens": toks[:, :-1], "labels": labels}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_grads_match_jax(arch, dtype):
    """``forward_loss`` at S = 24 (aux 0) and every parameter's gradient
    against ``jax.value_and_grad``; zamba2 at 4 layers, so that the shared
    block runs twice and its gradient is the sum of both uses."""
    kw = {"n_layers": 4} if arch == "zamba2-2.7b" else {}
    jcfg, jp, tp = _models(arch, dtype, seed=7, **kw)
    cfg = tp.cfg
    if arch == "zamba2-2.7b":
        assert len(tp.mamba) == 2
    batch = _batch(cfg, 24, seed=8)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: JM.forward_loss(p, b, jcfg), has_aux=True))(jp, batch)
    tp.requires_grad_(True)
    tl, tm = TM.forward_loss(tp, {k: _t(v) for k, v in batch.items()}, cfg)
    tl.backward()
    assert abs(float(tl.detach()) - float(jl)) <= LOSS_TOL[dtype] * abs(float(jl))
    assert float(tm["aux"]) == 0.0 == float(jm["aux"])
    assert int(tm["tokens"]) == int(jm["tokens"]) == 2 * 24 - 5
    grads = TM.params_to_numpy(pytree.tree_map(lambda p: p.grad,
                                               TM.param_tree(tp)))
    assert jax.tree.structure(grads) == jax.tree.structure(jg)
    for path, got, want in zip(pytree.paths(grads), jax.tree.leaves(grads),
                               jax.tree.leaves(jg)):
        assert got.shape == want.shape, path
        assert _rel(got, want) <= GRAD_TOL[dtype], path


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_gives_the_mamba_leaves_their_values(arch):
    cfg = get_config(arch).reduced()
    tp = TM.init_params(cfg, 0, device="cpu")
    blocks = TM._mamba_blocks(tp)
    assert len(blocks) == cfg.n_layers
    p = blocks[-1].p
    assert (p["A_log"] == 0).all() and (p["D"] == 1).all()
    assert (p["dt_bias"] == -2).all() and (p["conv_b"] == 0).all()
    assert (p["norm"] == 1).all() and (p["out_norm"] == 1).all()
    assert p["conv_w"].dtype == torch.float32
    assert torch.equal(p["conv_w"], p["conv_w"].bfloat16().float())
    assert p["in_proj"].dtype == p["out_proj"].dtype == torch.bfloat16
    so = 0.02 / (2 * cfg.n_layers) ** 0.5
    assert abs(float(p["out_proj"].float().std()) - so) < 0.15 * so
    assert abs(float(p["conv_w"].std()) - 0.1) < 0.015
    n = sum(w.numel() for w in tp.parameters())
    if arch == "mamba2-1.3b":
        # param_count counts 2 D a layer for its norm and conv bias (norm
        # D, conv_b d_inner + 2N), and misses final_norm
        conv_ch = cfg.d_inner + 2 * cfg.ssm_state
        assert n == cfg.param_count() + cfg.d_model \
            + cfg.n_layers * (conv_ch - cfg.d_model)
    else:
        assert tp.shared.p["wq"].shape == (cfg.d_model,
                                           cfg.n_heads * cfg.d_head)
