"""Serving deepseek-coder-33b: its ``reduced()`` config with the published
7:1 grouping of query heads over KV heads kept (14 heads over 2 KV heads
of 16, d_model 224, d_ff 600, 2 layers, vocab 256; the other dense tests
run 4 heads over 2), weights from JAX's ``init_params`` carried over by
``params_from_numpy``, against the JAX package.

- the port's ``deepseek-coder-33b`` config is the reference's, field for
  field, and so is its ``reduced()``;
- ``prefill`` and 3 ``decode_step``s: logits and every cache leaf within
  ``test_torch_models.py``'s ``TOL`` (f32 1e-5 prefill, 1e-3 decode; bf16
  2e-2), the cache positions equal;
- ``generate`` with a fused ``StreamingCalibrator``: the same tokens as
  without one, and the warm ``scale`` equal to JAX's calibrator's on the
  same logits and to the sort oracle's, bit for bit;
- ``calibrate_int8_scale`` over the port's K cache of every layer (the
  one-shot calibration ``chip_smoke.py``'s ``deepseek_serve_path`` runs at
  full width on a bf16 cache) equals JAX's on the same values and the sort
  oracle's."""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402
from repro.configs import get_config as jget_config           # noqa: E402
from repro.launch import serve as JS                          # noqa: E402
from repro.launch.quantile_service import (                   # noqa: E402
    StreamingCalibrator as JCalibrator)
from repro.models import model as JM                          # noqa: E402
from repro_torch.configs import get_config                    # noqa: E402
from repro_torch.launch import serve as TS                    # noqa: E402
from repro_torch.models import model as TM                    # noqa: E402

from test_torch_models import TOL, _assert_cache, _rel, _t    # noqa: E402
from test_torch_serve import Q, jb, tb                        # noqa: E402
from test_torch_serve_stream import _Tap, _close              # noqa: E402

ARCH = "deepseek-coder-33b"
GROUPED = dict(n_heads=14, n_kv_heads=2, d_head=16, d_model=224, d_ff=600)
B, S, GEN = 2, 20, 6


def _cfgs(dtype):
    def make(cfg):
        return dataclasses.replace(cfg.reduced(), param_dtype=dtype,
                                   **GROUPED)
    return make(jget_config(ARCH)), make(get_config(ARCH))


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def models(request):
    jcfg, cfg = _cfgs(request.param)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(5))
    tp = TM.params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                              device="cpu")
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (B, S + 3),
                                             dtype=np.int32)
    return request.param, jcfg, jp, cfg, tp, toks


def test_config_is_the_reference_s():
    jcfg, cfg = jget_config(ARCH), get_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(cfg.reduced()) == dataclasses.asdict(
        jcfg.reduced())
    assert cfg.param_count() == jcfg.param_count()
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.d_head, cfg.d_ff, cfg.vocab) == (62, 7168, 56, 8, 128,
                                                 19200, 32256)
    small = _cfgs("bfloat16")[1]
    assert small.n_heads // small.n_kv_heads == cfg.n_heads // cfg.n_kv_heads
    assert small.n_heads * small.d_head == small.d_model


def test_prefill_and_decode_match_jax(models):
    """Prefill of S = 20 into a cache of 26, then 3 decode steps (each of
    the 7 query heads of a group reading its one KV head)."""
    dtype, jcfg, jp, cfg, tp, toks = models
    C = S + 6
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


def test_generate_with_fused_calibrator_matches_jax_and_the_sort(models):
    _, _, _, cfg, tp, toks = models
    prompts = _t(toks[:, :S])
    cal = _Tap(Q, fused=True, device="cpu")
    jcal = JCalibrator(Q, fused=True)
    try:
        got = TS.generate(cfg, tp, prompts, gen_len=GEN, calibrator=cal)
        assert got.shape == (B, GEN) and len(cal.seen) == GEN
        assert torch.equal(got, TS.generate(cfg, tp, prompts, gen_len=GEN))
        for step in cal.seen:
            jcal.observe_many({k: jnp.asarray(v) for k, v in step.items()})
        n = cal.observed("logits")
        assert n == jcal.observed("logits") == GEN * B * cfg.vocab
        scale = cal.scale("logits")
        assert tb(scale) == jb(jcal.scale("logits"))
        seen = np.concatenate([s["logits"].ravel() for s in cal.seen])
        assert tb(scale) == np.sort(np.abs(seen))[math.ceil(Q * n) - 1] \
            .tobytes()
    finally:
        _close(cal)
        jcal.close()


def test_calibrate_int8_scale_over_the_k_cache_matches_jax(models):
    """The K cache of both layers after prefill(S) into a cache of S + GEN
    (its unwritten slots hold zeros), as the one-shot calibration takes it
    on the card."""
    dtype, _, _, cfg, tp, toks = models
    _, cache = TM.prefill(tp, {"tokens": _t(toks[:, :S])}, cfg,
                          cache_len=S + GEN)
    kc = cache["k"]
    assert kc.shape == (cfg.n_layers, B, S + GEN, cfg.n_kv_heads, cfg.d_head)
    assert kc.dtype == getattr(torch, dtype)
    x = jnp.asarray(kc.float().numpy()).astype(dtype)
    flat = np.abs(kc.float().numpy().ravel())
    for q in (0.5, Q):
        got = TS.calibrate_int8_scale(kc, q, device="cpu")
        assert tb(got) == jb(JS.calibrate_int8_scale(x, q))
        assert tb(got) == np.sort(flat)[math.ceil(q * flat.size) - 1] \
            .tobytes()
