"""The port's ssm and hybrid families (``repro_torch.models.ssm`` and those
branches of ``models.model``) against the JAX package's, on the same
weights.

Weights come from JAX's ``init_params`` with a seed and cross through
``params_from_numpy``; activations and prompts are numpy arrays from a
seed.  Covered at ``reduced()``: mamba2-1.3b (attention-free) and
zamba2-2.7b (a shared attention + SwiGLU block after every group of mamba
layers; 4 layers in 2 groups where the shared block's gradient is summed
over its uses).  Tolerances, a share of JAX's max |.|:

- f32 params: the conv, the scan, its states, prefill, decode and every
  cache leaf 1e-5 (measured gaps about 5e-7: the chunk's cumulative decay
  adds in XLA's order, ``sketch.blocked_cumsum``, and the rest differs by
  summation order only); bf16 params 2e-2 (measured about 1.1e-2: each
  package rounds its bf16 outputs);
- the chunked scan against the sequential oracle: 1e-2, the JAX test's
  (the intra-chunk product rounds its operands to bf16);
- ``forward_loss`` and gradients, as ``test_torch_train.py``: the loss
  f32 1e-6, bf16 1e-4; gradients f32 1e-5, bf16 3e-2;
- weights and checkpoints: bit for bit.

Also: a prompt shorter than ``ssm_conv - 1`` breaks the next decode step
in both packages (the reference's behaviour, pinned), and the serve CLI.

The cases are split over this file and ``test_torch_ssm_state.py``,
``test_torch_ssm_model.py`` and ``test_torch_ssm_cli.py``, so that xdist's
``--dist loadfile`` can run them on several workers; those files import
their helpers from here.
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402

from repro.configs import get_config as jget_config           # noqa: E402
from repro.models import model as JM                          # noqa: E402
from repro.models import ssm as JS                            # noqa: E402
from repro_torch.configs import get_config                    # noqa: E402
from repro_torch.models import model as TM                    # noqa: E402
from repro_torch.models import ssm as TS                      # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("mamba2-1.3b", "zamba2-2.7b")
DTYPES = ("float32", "bfloat16")
B, S = 2, 20
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
LOSS_TOL = {"float32": 1e-6, "bfloat16": 1e-4}
GRAD_TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _cfgs(arch, dtype="float32", **kw):
    return (dataclasses.replace(jget_config(arch).reduced(), param_dtype=dtype,
                                **kw),
            dataclasses.replace(get_config(arch).reduced(), param_dtype=dtype,
                                **kw))


def _f32(a):
    """A numpy leaf (or bf16 array) as f32; uint16 leaves are bf16 bits."""
    a = np.asarray(a)
    if a.dtype == np.uint16:
        return (a.astype(np.uint32) << 16).view(np.float32)
    return a.astype(np.float32)


def _rel(got, want):
    got, want = _f32(got), _f32(want)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _np(t):
    return t.detach().float().numpy()


def _t(a):
    return torch.from_numpy(np.array(a))


def _bits(a):
    a = np.asarray(a)
    return a.view({1: np.int8, 2: np.int16, 4: np.int32, 8: np.int64}[
        a.itemsize])


def _models(arch, dtype, seed=0, **kw):
    jcfg, cfg = _cfgs(arch, dtype, **kw)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    tp = TM.params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                              device="cpu")
    return jcfg, jp, tp


_MODELS = {}


def _shared_models(arch, dtype):
    """One JAX model and its port per (arch, dtype), for the read-only
    cases."""
    if (arch, dtype) not in _MODELS:
        _MODELS[arch, dtype] = _models(arch, dtype)
    return _MODELS[arch, dtype]


def _first_mamba(jp, tp):
    """Layer 0's mamba weights in both packages."""
    if "blocks" in jp:
        return jax.tree.map(lambda a: a[0], jp["blocks"]), tp.blocks[0].p
    return jax.tree.map(lambda a: a[0, 0], jp["mamba"]), tp.mamba[0][0].p


def _x(L, d, seed=1):
    return (np.random.default_rng(seed).normal(size=(B, L, d)) * 0.5).astype(
        np.float32)


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_causal_conv_matches_jax(dtype):
    _, jp, tp = _shared_models("mamba2-1.3b", dtype)
    lp, p = _first_mamba(jp, tp)
    C = p["conv_w"].shape[1]
    x = _x(S, C)
    want = JS._causal_conv(jnp.asarray(x).astype(dtype), lp["conv_w"],
                           lp["conv_b"] + 0.1)
    got = TS._causal_conv(_t(x).to(getattr(torch, dtype)), p["conv_w"],
                          p["conv_b"] + 0.1)
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, S, C)
    assert _rel(_np(got), want) <= TOL[dtype]


@pytest.mark.parametrize("L", [16, 19])
@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_forward_matches_jax(dtype, L):
    """The chunked scan (two whole chunks, and 19 with a padded last one)
    with ``return_state``: outputs, the final state and the conv state."""
    jcfg, jp, tp = _shared_models("mamba2-1.3b", dtype)
    lp, p = _first_mamba(jp, tp)
    x = _x(L, jcfg.d_model)
    jy, (js, jc) = JS.ssd_forward(lp, jnp.asarray(x).astype(dtype), jcfg,
                                  return_state=True)
    ty, (ts, tc) = TS.ssd_forward(p, _t(x).to(getattr(torch, dtype)), tp.cfg,
                                  return_state=True)
    assert ty.shape == jy.shape and ts.dtype == torch.float32
    assert tc.shape == jc.shape == (B, jcfg.ssm_conv - 1,
                                    jcfg.d_inner + 2 * jcfg.ssm_state)
    assert _rel(_np(ty), jy) <= TOL[dtype]
    assert _rel(ts.numpy(), js) <= TOL[dtype]
    np.testing.assert_array_equal(_bits(_np(tc)), _bits(_f32(jc)))


@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_decode_and_reference_match_jax(dtype):
    """``ssd_reference`` (L decode steps from zeros) in both packages, and
    one ``ssd_decode`` from a nonzero cache, which the port writes in
    place."""
    jcfg, jp, tp = _shared_models("mamba2-1.3b", dtype)
    lp, p = _first_mamba(jp, tp)
    x = _x(12, jcfg.d_model)
    jx, tx = jnp.asarray(x).astype(dtype), _t(x).to(getattr(torch, dtype))
    want = JS.ssd_reference(lp, jx, jcfg)
    got = TS.ssd_reference(p, tx, tp.cfg)
    assert _rel(_np(got), want) <= TOL[dtype]

    rng = np.random.default_rng(5)
    ssm0 = rng.normal(size=(B, jcfg.ssm_heads, jcfg.ssm_head_dim,
                            jcfg.ssm_state)).astype(np.float32)
    conv0 = rng.normal(size=(B, jcfg.ssm_conv - 1,
                             jcfg.d_inner + 2 * jcfg.ssm_state))
    jo, jcache = JS.ssd_decode(lp, jx[:, :1], jcfg, {
        "ssm": jnp.asarray(ssm0), "conv": jnp.asarray(conv0).astype(dtype)})
    cache = {"ssm": _t(ssm0), "conv": _t(conv0).to(getattr(torch, dtype))}
    ssm_buf, conv_buf = cache["ssm"], cache["conv"]
    to, tcache = TS.ssd_decode(p, tx[:, :1], tp.cfg, cache)
    assert tcache["ssm"] is ssm_buf and tcache["conv"] is conv_buf
    assert _rel(_np(to), jo) <= TOL[dtype]
    assert _rel(ssm_buf.numpy(), jcache["ssm"]) <= TOL[dtype]
    assert _rel(_np(conv_buf), jcache["conv"]) <= TOL[dtype]
