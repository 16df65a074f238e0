"""Reduced seamless-m4t-large-v2 in the port against the JAX package's:
prefill, decode and every self and cross cache leaf, ``forward_loss`` and
every gradient, on the direct and the blockwise attention paths (models,
helpers and tolerances: ``test_torch_audio.py``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402
from repro.models import model as JM                          # noqa: E402
from repro_torch import pytree                                # noqa: E402
from repro_torch.models import model as TM                    # noqa: E402

from test_torch_audio import (B, DTYPES, GRAD_TOL, LOSS_TOL,  # noqa: E402
                              TOL, _frames, _models, _np, _rel, _t)


def _check_cache(tc, jc, tol, where):
    assert pytree.paths(tc) == [jax.tree_util.keystr(k) for k, _ in
                                jax.tree_util.tree_leaves_with_path(jc)]
    for path, got, want in zip(pytree.paths(tc), pytree.leaves(tc),
                               jax.tree.leaves(jc)):
        assert tuple(got.shape) == want.shape, path
        if got.dtype == torch.int32:
            np.testing.assert_array_equal(got.numpy(), want)
        else:
            assert _rel(_np(got), want) <= tol, (where, path)


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_and_decode_match_jax(dtype):
    """Prefill of S = 20 tokens and 5 frames into a cache of 26, then 3
    decode steps: the logits and every cache leaf each step, the cross
    cache ((L, B, 5, KV, dh), filled once by prefill) included, under
    JAX's paths; positions exactly."""
    jcfg, jp, tp = _models(dtype, seed=1)
    cfg, S, C = tp.cfg, 20, 26
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (B, S + 3),
                                             dtype=np.int32)
    frames = _frames(cfg, S // cfg.enc_seq_divisor, seed=3)
    jl, jc = jax.jit(lambda p, t, f: JM.prefill(
        p, {"tokens": t, "frames": f}, jcfg, cache_len=C))(
            jp, toks[:, :S], frames)
    tl, tc = TM.prefill(tp, {"tokens": _t(toks[:, :S]),
                             "frames": _t(frames)}, cfg, cache_len=C)
    assert tl.dtype == torch.float32 and tl.shape == (B, cfg.vocab)
    assert tc["cross"]["k"].shape == (cfg.n_layers, B, 5, cfg.n_kv_heads,
                                      cfg.d_head)
    assert _rel(tl.numpy(), jl) <= TOL[dtype, "prefill"]
    _check_cache(tc, jc, TOL[dtype, "prefill"], "prefill")
    cross = [t.clone() for t in pytree.leaves(tc["cross"])]
    decode = jax.jit(lambda p, t, c, n: JM.decode_step(p, t, c, n, jcfg))
    for i in range(3):
        n = np.full((B,), S + i, np.int32)
        tok = toks[:, S + i:S + i + 1]
        jl, jc = decode(jp, tok, jc, n)
        tl, tc2 = TM.decode_step(tp, _t(tok), tc, _t(n), cfg)
        assert tc2 is tc
        assert _rel(tl.numpy(), jl) <= TOL[dtype, "decode"], i
        _check_cache(tc, jc, TOL[dtype, "decode"], i)
    assert all(torch.equal(a, b)
               for a, b in zip(cross, pytree.leaves(tc["cross"])))


def _batch(cfg, n, n_frames, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, n + 1), dtype=np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :5] = -1
    return {"tokens": toks[:, :-1], "labels": labels,
            "frames": _frames(cfg, n_frames, seed + 1)}


# name: (tokens, frames).  "blockwise": the encoder (64 x 64), the
# cross-attention (64 x 64) and the decoder's self-attention (64 x 64) each
# score 4096 > 2 x 16 x 32 and take the blockwise path, Sk a multiple of 32
LOSS_CASES = {"direct": (20, 5), "blockwise": (64, 64)}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_forward_loss_and_grads_match_jax(case, dtype):
    """``forward_loss`` (aux 0) and every parameter's gradient, the
    encoder's, ``enc_norm`` and the cross leaves included, against
    ``jax.value_and_grad`` of the reference's."""
    S, Sf = LOSS_CASES[case]
    jcfg, jp, tp = _models(dtype, seed=7)
    cfg = tp.cfg
    if case == "blockwise":
        assert min(S * S, S * Sf, Sf * Sf) > 2 * cfg.attn_q_block \
            * cfg.attn_kv_block and Sf % cfg.attn_kv_block == 0
    batch = _batch(cfg, S, Sf, seed=8)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: JM.forward_loss(p, b, jcfg), has_aux=True))(jp, batch)
    tp.requires_grad_(True)
    tl, tm = TM.forward_loss(tp, {k: _t(v) for k, v in batch.items()}, cfg)
    tl.backward()
    assert abs(float(tl.detach()) - float(jl)) <= LOSS_TOL[dtype] * abs(
        float(jl))
    assert float(tm["aux"]) == 0.0 == float(jm["aux"])
    assert int(tm["tokens"]) == int(jm["tokens"]) == B * S - 5
    grads = TM.params_to_numpy(pytree.tree_map(lambda p: p.grad,
                                               TM.param_tree(tp)))
    assert jax.tree.structure(grads) == jax.tree.structure(jg)
    for path, got, want in zip(pytree.paths(grads), jax.tree.leaves(grads),
                               jax.tree.leaves(jg)):
        assert got.shape == want.shape, path
        assert _rel(got, want) <= GRAD_TOL[dtype], path
