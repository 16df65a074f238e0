"""The port's dense models' prefill and decode against the JAX package's:
every cache leaf each step, the sliding-window ring, the reference's SWA
prefill quirk and greedy tokens (helpers and tolerances:
``test_torch_models.py``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402
from repro.models import model as JM                          # noqa: E402
from repro_torch.launch import serve as TS                    # noqa: E402
from repro_torch.models import model as TM                    # noqa: E402

from test_torch_models import (ARCHS, B, S, TOL, _assert_cache,
    _models, _rel, _t)


def _prompts(cfg, n, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, n),
                                                dtype=np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch, dtype):
    """Prefill of S = 20 into a cache of 26 (the blockwise path at these
    blocks), then 3 decode steps; logits and every cache leaf each step."""
    jcfg, jp, tp = _models(arch, dtype, seed=3)
    cfg, C = tp.cfg, S + 6
    toks = _prompts(cfg, S + 3, seed=4)
    jl, jc = jax.jit(lambda p, t: JM.prefill(p, {"tokens": t}, jcfg,
                                             cache_len=C))(jp, toks[:, :S])
    tl, tc = TM.prefill(tp, {"tokens": _t(toks[:, :S])}, cfg, cache_len=C)
    assert tl.dtype == torch.float32 and tl.shape == (B, cfg.vocab)
    assert _rel(tl.numpy(), jl) <= TOL[dtype, "prefill"]
    _assert_cache(jc, tc, TOL[dtype, "prefill"])
    decode = jax.jit(lambda p, t, c, n: JM.decode_step(p, t, c, n, jcfg))
    for i in range(3):
        n = np.full((B,), S + i, np.int32)
        tok = toks[:, S + i:S + i + 1]
        jl, jc = decode(jp, tok, jc, n)
        tl, tc = TM.decode_step(tp, _t(tok), tc, _t(n), cfg)
        assert _rel(tl.numpy(), jl) <= TOL[dtype, "decode"], i
        _assert_cache(jc, tc, TOL[dtype, "decode"])


def test_decode_past_the_window_uses_the_ring():
    """h2o-danube (window 32 at reduced): a prompt of 24 in a ring of
    min(24 + 16, 32) = 32 slots, then 14 decode steps, the last 6 of them
    writing at ``cache_len % 32`` over the oldest positions."""
    jcfg, jp, tp = _models("h2o-danube-1.8b", "float32", seed=5)
    cfg = tp.cfg
    W = cfg.swa_window
    toks = _prompts(cfg, 24 + 14, seed=6)
    jl, jc = jax.jit(lambda p, t: JM.prefill(p, {"tokens": t}, jcfg,
                                             cache_len=40))(jp, toks[:, :24])
    tl, tc = TM.prefill(tp, {"tokens": _t(toks[:, :24])}, cfg, cache_len=40)
    assert tc["k"].shape[2] == W
    assert _rel(tl.numpy(), jl) <= TOL["float32", "prefill"]
    decode = jax.jit(lambda p, t, c, n: JM.decode_step(p, t, c, n, jcfg))
    for i in range(14):
        n = np.full((B,), 24 + i, np.int32)
        tok = toks[:, 24 + i:25 + i]
        jl, jc = decode(jp, tok, jc, n)
        tl, tc = TM.decode_step(tp, _t(tok), tc, _t(n), cfg)
        assert _rel(tl.numpy(), jl) <= TOL["float32", "decode"], i
        _assert_cache(jc, tc, TOL["float32", "decode"])
    # positions 32..37 overwrote slots 0..5
    assert tc["pos"][0, 0, :6].tolist() == list(range(32, 38))
    assert tc["pos"][0, 0, 6:].tolist() == list(range(6, 32))


def test_swa_prefill_longer_than_the_cache_keeps_the_reference_quirk():
    """A prompt of 40 into a ring of 32 (cache_len 40 > window 32 writes
    only positions 8..39 at slots 0..31), and every query then attends
    over that cache alone: queries before the last window do not see their
    own window.  The port mirrors the reference, so its logits are JAX's
    and differ from the same prompt run with no cache."""
    jcfg, jp, tp = _models("h2o-danube-1.8b", "float32", seed=7)
    cfg = tp.cfg
    toks = _prompts(cfg, 40, seed=8)
    jl, jc = jax.jit(lambda p, t: JM.prefill(p, {"tokens": t}, jcfg,
                                             cache_len=40))(jp, toks)
    tl, tc = TM.prefill(tp, {"tokens": _t(toks)}, cfg, cache_len=40)
    assert tc["pos"][0, 0].tolist() == list(range(8, 40))
    assert _rel(tl.numpy(), jl) <= TOL["float32", "prefill"]
    _assert_cache(jc, tc, TOL["float32", "prefill"])
    # the same blocks with no cache: every query sees its own window
    x, positions, _ = TM._embed_inputs(tp.p, {"tokens": _t(toks)}, cfg)
    for block in tp.blocks:
        x, _ = block(x, positions=positions)
    full = TM._logits(tp, x[:, -1:], cfg)
    assert _rel(full.numpy(), jl) > 1e-3


def test_greedy_tokens_match_jax():
    """8 greedy steps of granite-8b (reduced, f32 params): each token is
    JAX's wherever JAX's top-2 logit gap exceeds the decode tolerance, up
    to the first step where it does not (the two runs may part there).
    Sampling draws from a seeded ``torch.Generator``: reproducible, but
    not JAX's draws, so it is compared with itself only."""
    jcfg, jp, tp = _models("granite-8b", "float32", seed=9)
    cfg = tp.cfg
    prompts = _prompts(cfg, S, seed=10)
    got = TS.generate(cfg, tp, _t(prompts), gen_len=8)
    assert got.dtype == torch.int32 and got.shape == (B, 8)
    jl, jc = jax.jit(lambda p, t: JM.prefill(p, {"tokens": t}, jcfg,
                                             cache_len=S + 8))(jp, prompts)
    decode = jax.jit(lambda p, t, c, n: JM.decode_step(p, t, c, n, jcfg))
    checked = 0
    for i in range(8):
        lg = np.asarray(jl)
        top2 = np.sort(lg, axis=-1)[:, -2:]
        tol = TOL["float32", "decode"] * np.abs(lg).max()
        if not (top2[:, 1] - top2[:, 0] > tol).all():
            break
        tok = lg.argmax(-1).astype(np.int32)
        assert got[:, i].tolist() == tok.tolist(), i
        checked += 1
        jl, jc = decode(jp, tok[:, None], jc, np.full((B,), S + i, np.int32))
    assert checked >= 4
    a = TS.generate(cfg, tp, _t(prompts), gen_len=4, greedy=False, seed=3)
    b = TS.generate(cfg, tp, _t(prompts), gen_len=4, greedy=False, seed=3)
    assert torch.equal(a, b)
