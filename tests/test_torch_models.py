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
behaviour), greedy tokens over 8 steps, and the family the port does not
have raising.

The cases are split over this file and ``test_torch_models_decode.py`` and
``test_torch_models_depth.py``, so that xdist's ``--dist loadfile`` can
run them on several workers; those files import their helpers from here.
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
    # not causal (the encoder's and cross-attention's mask): window only.
    # The reference's blockwise path lets the keys that pad Sk = 37 to
    # whole kv blocks through when it is not causal
    # (test_torch_flash_padding.py pins it), so the port's blockwise
    # answer is held to the reference's direct path
    kw["causal"] = False
    want = JL.attention(q, k, v, pq, pk, **dict(kw, q_block=Sq, kv_block=Sk))
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
