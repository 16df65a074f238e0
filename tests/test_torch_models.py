"""The port's dense serving model (``repro_torch.models``) against the JAX
package's, on the same weights.

Weights come from JAX's ``init_params`` with a seed and cross through
``params_from_numpy``; prompts are numpy integers from a seed.  Covered at
``reduced()``: granite-8b (RMSNorm, GQA), stablelm-1.6b (LayerNorm with
bias, MHA) and h2o-danube-1.8b (sliding window).  Tolerances, as a share of
JAX's max |logit| (or max |output| for a layer):

- f32 params: prefill and the f32 layers 1e-5; decode 1e-3 (JAX's decode
  attention takes q, the cache and the probabilities to bf16, and the port
  mirrors those casts, so the two differ where a rounding flips);
- bf16 params: 2e-2 for prefill and decode;
- cache positions: equal exactly.

Also: decode past the window (the ring slot ``cache_len % window``), the
reference's SWA prefill with a prompt longer than the cache (every query
attends over the last window alone, pinned here as the reference's
behaviour), greedy tokens over 8 steps, and the families the port does not
have raising.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402

from repro.configs import get_config as jget_config           # noqa: E402
from repro.models import layers as JL                         # noqa: E402
from repro.models import model as JM                          # noqa: E402
from repro_torch.configs import (ARCH_IDS, REGISTRY,           # noqa: E402
                                 get_config)
from repro_torch.launch import serve as TS                    # noqa: E402
from repro_torch.models import layers as TL                   # noqa: E402
from repro_torch.models import model as TM                    # noqa: E402

ARCHS = ("granite-8b", "stablelm-1.6b", "h2o-danube-1.8b")
B, S = 2, 20
TOL = {("float32", "prefill"): 1e-5, ("float32", "decode"): 1e-3,
       ("bfloat16", "prefill"): 2e-2, ("bfloat16", "decode"): 2e-2}


def _cfg(arch, dtype="float32"):
    return dataclasses.replace(get_config(arch).reduced(), param_dtype=dtype)


def _jcfg(arch, dtype="float32"):
    return dataclasses.replace(jget_config(arch).reduced(), param_dtype=dtype)


def _np(t):
    return t.detach().float().numpy() if t.dtype == torch.bfloat16 \
        else t.detach().numpy()


def _rel(got, want):
    want = np.asarray(want, np.float32)
    err = np.abs(np.asarray(got, np.float32) - want).max()
    return err / max(np.abs(want).max(), 1e-30)


def _t(a):
    return torch.from_numpy(np.array(a))


def _models(arch, dtype, seed=0):
    jcfg = _jcfg(arch, dtype)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    tp = TM.params_from_numpy(_cfg(arch, dtype), jax.tree.map(np.asarray, jp),
                              device="cpu")
    return jcfg, jp, tp


def _prompts(cfg, n, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, n),
                                                dtype=np.int32)


def _assert_cache(jc, tc, tol):
    assert np.array_equal(np.asarray(jc["pos"]), tc["pos"].numpy())
    for leaf in ("k", "v"):
        assert _rel(_np(tc[leaf]), jc[leaf]) <= tol, leaf


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def test_config_copy_and_registry_match_jax():
    from repro.configs import REGISTRY as JREG
    assert ARCH_IDS == tuple(sorted(JREG))
    for name, cfg in REGISTRY.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(JREG[name])
        assert cfg.param_count() == JREG[name].param_count()
        assert dataclasses.asdict(cfg.reduced()) == dataclasses.asdict(
            JREG[name].reduced())
    with pytest.raises(KeyError):
        get_config("no-such-arch")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_and_rope_match_jax(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 4, 16)).astype(np.float32) * 3
    w = rng.normal(size=(16,)).astype(np.float32)
    b = rng.normal(size=(16,)).astype(np.float32)
    pos = rng.integers(0, 5000, (2, 5)).astype(np.int32)
    jx = jnp.asarray(x).astype(dtype)
    tx = _t(x).to(getattr(torch, dtype))
    tol = 1e-6 if dtype == "float32" else 1e-2
    assert _rel(_np(TL.rmsnorm(tx, _t(w))), JL.rmsnorm(jx, w)) <= tol
    assert _rel(_np(TL.layernorm(tx, _t(w), _t(b))),
                JL.layernorm(jx, w, b)) <= tol
    for theta in (10000.0, 1e6):
        assert _rel(_np(TL.apply_rope(tx, _t(pos), theta)),
                    JL.apply_rope(jx, pos, theta)) <= tol
    assert _rel(TL.rope_freqs(16, 1e4).numpy(), JL.rope_freqs(16, 1e4)) \
        <= 1e-7


def _qkv(rng, Sq, Sk, NH=4, KV=2, dh=16):
    q = rng.normal(size=(B, Sq, NH, dh)).astype(np.float32)
    k = rng.normal(size=(B, Sk, KV, dh)).astype(np.float32)
    v = rng.normal(size=(B, Sk, KV, dh)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("window", [0, 7])
def test_attention_paths_match_jax(window):
    """The decode path (Sq = 1, bf16 operands), the direct f32 path and the
    blockwise path, with absolute positions, unwritten cache slots at 2^30
    and a query that sees no key (its row softmaxes over the raw scores,
    as the additive -1e30 bias gives, and is not NaN)."""
    rng = np.random.default_rng(1 + window)
    kw = dict(causal=True, window=window, q_block=8, kv_block=16)
    # decode over a cache with unwritten tail slots
    q, k, v = _qkv(rng, 1, 24)
    pk = np.tile(np.arange(24, dtype=np.int32), (B, 1))
    pk[:, 17:] = 2 ** 30
    pq = np.full((B, 1), 16, np.int32)
    want = JL.attention(q, k, v, pq, pk, **kw)
    got = TL.attention(*map(_t, (q, k, v, pq, pk)), **kw)
    assert _rel(got.numpy(), want) <= 1e-3
    # the same through kv_len instead of the sentinel
    kv_len = np.array([17, 9], np.int32)
    pk2 = np.tile(np.arange(24, dtype=np.int32), (B, 1))
    want = JL.attention(q, k, v, pq, pk2, kv_len=kv_len, **kw)
    got = TL.attention(*map(_t, (q, k, v, pq, pk2)), kv_len=_t(kv_len), **kw)
    assert _rel(got.numpy(), want) <= 1e-3
    # direct (Sq * Sk <= 2 q_block kv_block) and blockwise (beyond it)
    for Sq, Sk in ((10, 12), (21, 37)):
        q, k, v = _qkv(rng, Sq, Sk)
        pq = np.tile(np.arange(Sk - Sq, Sk, dtype=np.int32), (B, 1))
        pq[0, 0] = -1                               # sees no key at all
        pk = np.tile(np.arange(Sk, dtype=np.int32), (B, 1))
        want = JL.attention(q, k, v, pq, pk, **kw)
        got = TL.attention(*map(_t, (q, k, v, pq, pk)), **kw)
        assert np.isfinite(got.numpy()).all()
        assert _rel(got.numpy(), want) <= 1e-5, (Sq, Sk)
    # not causal (the encoder's and cross-attention's mask): window only
    kw["causal"] = False
    want = JL.attention(q, k, v, pq, pk, **kw)
    got = TL.attention(*map(_t, (q, k, v, pq, pk)), **kw)
    assert _rel(got.numpy(), want) <= 1e-5
    with pytest.raises(ValueError):
        TL.attention(*map(_t, (q, k, v, pq, pk)), kv_len=_t(kv_len), **kw)


@pytest.mark.parametrize("arch", ARCHS)
def test_attn_block_with_cache_matches_jax(arch):
    """One layer's attention sub-block writing a prompt into its cache at
    slot 0, then one token at ``kv_len[0]`` (in place in the port)."""
    jcfg, jp, tp = _models(arch, "float32")
    cfg = tp.cfg
    lp = jax.tree.map(lambda a: a[0], jp["blocks"])
    rng = np.random.default_rng(2)
    x = rng.normal(size=(B, 6, cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(6, dtype=np.int32), (B, 1))
    jc = {k: v[0] for k, v in JM.init_cache(jcfg, B, 10).items()}
    tc = {k: v[0] for k, v in TM.init_cache(cfg, B, 10, device="cpu").items()}
    jo, jc = JL.attn_block(lp, x, jcfg, positions=pos, cache=jc,
                           kv_len=np.zeros(B, np.int32))
    to, tc2 = TL.attn_block(tp.blocks[0].p, _t(x), cfg, positions=_t(pos),
                            cache=tc, kv_len=torch.zeros(B, dtype=torch.int32))
    assert tc2 is tc
    assert _rel(to.numpy(), jo) <= 1e-5
    _assert_cache(jc, tc, 1e-6)
    x1 = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    p1 = np.full((B, 1), 6, np.int32)
    jo, jc = JL.attn_block(lp, x1, jcfg, positions=p1, cache=jc,
                           kv_len=np.full(B, 6, np.int32))
    to, _ = TL.attn_block(tp.blocks[0].p, _t(x1), cfg, positions=_t(p1),
                          cache=tc, kv_len=torch.full((B,), 6,
                                                      dtype=torch.int32))
    assert _rel(to.numpy(), jo) <= 1e-3
    _assert_cache(jc, tc, 1e-6)
    assert (tc["pos"][:, 7:] == TL.UNWRITTEN).all()


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------


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


# ---------------------------------------------------------------------------
# construction
# ---------------------------------------------------------------------------


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


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-2.7b",
                                  "seamless-m4t-large-v2"])
def test_unported_families_raise(arch):
    cfg = get_config(arch).reduced()
    for build in (lambda: TM.Transformer(cfg, device="cpu"),
                  lambda: TM.init_params(cfg, 0, device="cpu"),
                  lambda: TM.init_cache(cfg, 1, 8, device="cpu")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            build()
