"""Reduced olmoe-1b-7b and arctic-480b in the port against the JAX
package's: prefill and decode (with drops) and greedy tokens (helpers and
tolerances: ``test_torch_moe.py``)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402
from repro.models import model as JM                          # noqa: E402
from repro_torch.launch import serve as TS                    # noqa: E402
from repro_torch.models import model as TM                    # noqa: E402
from repro_torch.models import moe as TMoE                    # noqa: E402

from test_torch_moe import (ARCHS, B, S, TOL, _models, _np, _rel, _t)  # noqa: E402


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch, dtype):
    """Prefill of S = 20 into a cache of 26, then 3 decode steps (T = 2:
    every expert's capacity is the whole batch); logits and every cache
    leaf each step."""
    jcfg, jp, tp = _models(arch, dtype, seed=3)
    cfg, C = tp.cfg, S + 6
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (B, S + 3),
                                             dtype=np.int32)
    jl, jc = jax.jit(lambda p, t: JM.prefill(p, {"tokens": t}, jcfg,
                                             cache_len=C))(jp, toks[:, :S])
    tl, tc = TM.prefill(tp, {"tokens": _t(toks[:, :S])}, cfg, cache_len=C)
    assert tl.dtype == torch.float32 and tl.shape == (B, cfg.vocab)
    assert _rel(tl.numpy(), jl) <= TOL[dtype, "prefill"]
    decode = jax.jit(lambda p, t, c, n: JM.decode_step(p, t, c, n, jcfg))
    for i in range(3):
        np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
        for leaf in ("k", "v"):
            assert _rel(_np(tc[leaf]), jc[leaf]) <= TOL[dtype, "decode"]
        n = np.full((B,), S + i, np.int32)
        tok = toks[:, S + i:S + i + 1]
        jl, jc = decode(jp, tok, jc, n)
        tl, tc = TM.decode_step(tp, _t(tok), tc, _t(n), cfg)
        assert _rel(tl.numpy(), jl) <= TOL[dtype, "decode"], i


def test_prefill_with_drops_matches_jax():
    """Prefill at capacity factor 1 (given to ``prefill`` on a model built
    at ``reduced()``'s 4: the functions use the config they are passed, as
    the reference's do), where experts overflow and drop assignments in
    every layer; and a decode step after it (dropless: cap = T = 2)."""
    jcfg, jp, tp = _models("olmoe-1b-7b", "float32", seed=10)
    jcfg = dataclasses.replace(jcfg, moe_capacity_factor=1.0)
    cfg = dataclasses.replace(tp.cfg, moe_capacity_factor=1.0)
    toks = np.random.default_rng(11).integers(0, cfg.vocab, (B, S + 1),
                                              dtype=np.int32)
    jl, jc = jax.jit(lambda p, t: JM.prefill(p, {"tokens": t}, jcfg,
                                             cache_len=S + 1))(jp, toks[:, :S])
    dropped = []
    block = TMoE.moe_block

    def tap(p, x, c):
        T = x.shape[0] * x.shape[1]
        _, _, top_i = TMoE.route(p, x.reshape(T, -1), c)
        dropped.append(int((~TMoE.dispatch(top_i, TMoE.capacity(T, c),
                                           c.moe_experts).keep).sum()))
        return block(p, x, c)
    TMoE.moe_block = tap
    try:
        tl, tc = TM.prefill(tp, {"tokens": _t(toks[:, :S])}, cfg,
                            cache_len=S + 1)
    finally:
        TMoE.moe_block = block
    assert len(dropped) == cfg.n_layers and min(dropped) > 0
    assert _rel(tl.numpy(), jl) <= TOL["float32", "prefill"]
    n = np.full((B,), S, np.int32)
    jl, _ = jax.jit(lambda p, t, c, n: JM.decode_step(p, t, c, n, jcfg))(
        jp, toks[:, S:], jc, n)
    tl, _ = TM.decode_step(tp, _t(toks[:, S:]), tc, _t(n), cfg)
    assert _rel(tl.numpy(), jl) <= TOL["float32", "decode"]


def test_greedy_tokens_match_jax():
    """8 greedy steps of olmoe-1b-7b (reduced, f32 params): each token is
    JAX's wherever JAX's top-2 logit gap exceeds the decode tolerance, up
    to the first step where it does not."""
    jcfg, jp, tp = _models("olmoe-1b-7b", "float32", seed=5)
    cfg = tp.cfg
    prompts = np.random.default_rng(6).integers(0, cfg.vocab, (B, S),
                                                dtype=np.int32)
    got = TS.generate(cfg, tp, _t(prompts), gen_len=8)
    assert got.dtype == torch.int32 and got.shape == (B, 8)
    jl, jc = jax.jit(lambda p, t: JM.prefill(p, {"tokens": t}, jcfg,
                                             cache_len=S + 8))(jp, prompts)
    decode = jax.jit(lambda p, t, c, n: JM.decode_step(p, t, c, n, jcfg))
    checked = 0
    for i in range(8):
        lg = np.asarray(jl)
        top2 = np.sort(lg, axis=-1)[:, -2:]
        if not (top2[:, 1] - top2[:, 0] > 1e-3 * np.abs(lg).max()).all():
            break
        tok = lg.argmax(-1).astype(np.int32)
        assert got[:, i].tolist() == tok.tolist(), i
        checked += 1
        jl, jc = decode(jp, tok[:, None], jc, np.full((B,), S + i, np.int32))
    assert checked >= 4
    assert torch.equal(TS.generate(cfg, tp, _t(prompts), gen_len=8), got)
