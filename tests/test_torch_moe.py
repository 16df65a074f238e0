"""The port's moe family (``repro_torch.models.moe`` and the moe branch of
``models.model``) against the JAX package's, on the same weights.

Weights come from JAX's ``init_params`` with a seed and cross through
``params_from_numpy``; activations and prompts are numpy arrays from a
seed.  Covered at ``reduced()``: olmoe-1b-7b (64 experts top-8 cut to 4
top-2) and arctic-480b (the dense residual beside the experts).
Tolerances, as in ``test_torch_models.py``, a share of JAX's max |.|:

- ``moe_block`` and prefill: f32 1e-5, bf16 2e-2; decode: f32 1e-3, bf16
  2e-2; the load-balance loss 1e-6 (f32 routing on the same inputs);
- the routing (each token's experts and which assignments are dropped):
  identical;
- ``forward_loss`` and gradients, as ``test_torch_train.py``: the loss and
  the summed load-balance loss f32 1e-6, bf16 1e-4 (the layers' inputs
  differ by bf16 rounding there); gradients f32 1e-5, bf16 3e-2.

Also: drops at capacity factor 1 (the latest tokens of an overfull expert),
ties (the lower expert first), the ``dots`` policy recomputing the experts'
batched matmuls, a checkpoint crossing both packages, and the serve and
train CLIs.

The cases are split over this file and ``test_torch_moe_decode.py`` and
``test_torch_moe_train.py``, so that xdist's ``--dist loadfile`` can run
them on several workers; those files import their helpers from here.
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
from repro.models import moe as JMoE                          # noqa: E402
from repro_torch.configs import get_config                    # noqa: E402
from repro_torch.models import model as TM                    # noqa: E402
from repro_torch.models import moe as TMoE                    # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("olmoe-1b-7b", "arctic-480b")
B, S = 2, 20
TOL = {("float32", "prefill"): 1e-5, ("float32", "decode"): 1e-3,
       ("bfloat16", "prefill"): 2e-2, ("bfloat16", "decode"): 2e-2}
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


def _models(arch, dtype, seed=0, **kw):
    jcfg, cfg = _cfgs(arch, dtype, **kw)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    tp = TM.params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                              device="cpu")
    return jcfg, jp, tp


def _jax_routing(lp, x, cfg):
    """The reference's routing (``repro/models/moe.py``'s own lines): each
    token's top-k experts (T, k) and whether each of its assignments is
    kept (T, k)."""
    T = x.shape[0] * x.shape[1]
    E, k = cfg.moe_experts, cfg.moe_top_k
    xt = jnp.asarray(x).reshape(T, -1)
    probs = jax.nn.softmax(xt.astype(jnp.float32) @ lp["router"], axis=-1)
    _, top_i = jax.lax.top_k(probs, k)
    cap = int(-(-T * k // E) * cfg.moe_capacity_factor)
    cap = max(min(8, T), min(cap, T))
    eid = top_i.reshape(-1)
    order = jnp.argsort(eid)
    eid_s = eid[order]
    start = jnp.searchsorted(eid_s, jnp.arange(E, dtype=eid_s.dtype),
                             side="left")
    keep_s = jnp.arange(T * k) - start[eid_s] < cap
    keep = jnp.zeros(T * k, bool).at[order].set(keep_s)
    return np.asarray(top_i), np.asarray(keep).reshape(T, k)


def _port_routing(p, x, cfg):
    T = x.shape[0] * x.shape[1]
    _, _, top_i = TMoE.route(p, x.reshape(T, -1), cfg)
    d = TMoE.dispatch(top_i, TMoE.capacity(T, cfg), cfg.moe_experts)
    keep = torch.empty_like(d.keep).scatter_(0, d.order, d.keep)
    return top_i.numpy(), keep.view(T, -1).numpy()


def _block_case(arch, dtype, x, seed=0, edit=None, **kw):
    """Layer 0's ``moe_block`` in both packages on x: (JAX y, aux, port y,
    aux, JAX routing, port routing)."""
    jcfg, jp, tp = _models(arch, dtype, seed, **kw)
    lp = jax.tree.map(lambda a: a[0], jp["blocks"])
    p = tp.blocks[0].p
    if edit is not None:
        lp = dict(lp, router=jnp.asarray(edit(np.asarray(lp["router"]))))
        p = dict(p, router=_t(np.asarray(lp["router"])))
    jx = jnp.asarray(x).astype(dtype)
    tx = _t(x).to(getattr(torch, dtype))
    jy, jaux = jax.jit(lambda p_, x_: JMoE.moe_block(p_, x_, jcfg))(lp, jx)
    ty, taux = TMoE.moe_block(p, tx, tp.cfg)
    assert ty.dtype == tx.dtype and ty.shape == tx.shape
    return (np.asarray(jy.astype(jnp.float32)), float(jaux), _np(ty),
            float(taux), _jax_routing(lp, jx, jcfg),
            _port_routing(p, tx, tp.cfg))


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_matches_jax(arch, dtype):
    """y, the load-balance loss and the identical routing (dropless at
    ``reduced()``'s capacity factor 4)."""
    x = np.random.default_rng(1).normal(size=(B, S, 64)).astype(np.float32)
    jy, jaux, ty, taux, (jtop, jkeep), (ttop, tkeep) = _block_case(
        arch, dtype, x)
    np.testing.assert_array_equal(ttop, jtop)
    np.testing.assert_array_equal(tkeep, jkeep)
    assert tkeep.all()
    assert _rel(ty, jy) <= TOL[dtype, "prefill"]
    assert abs(taux - jaux) <= 1e-6 * abs(jaux)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_drops_match_jax(dtype):
    """Capacity factor 1 and a router that sends every token to expert 0
    first (its input has a large mean in channel 0): cap = 20 of 40 tokens,
    so expert 0 drops its latest 20 assignments, and an expert of the
    second choices overflows too; the same assignments drop in both
    packages, and the outputs agree."""
    x = np.random.default_rng(2).normal(size=(B, S, 64)).astype(np.float32)
    x[..., 0] += 4.0

    def skew(router):
        router = router.copy()
        router[0, 0] = 2.0
        return router

    jy, jaux, ty, taux, (jtop, jkeep), (ttop, tkeep) = _block_case(
        "olmoe-1b-7b", dtype, x, edit=skew, moe_capacity_factor=1.0)
    np.testing.assert_array_equal(ttop, jtop)
    assert (jtop[:, 0] == 0).all()
    np.testing.assert_array_equal(tkeep, jkeep)
    assert not tkeep[20:, 0].any() and tkeep[:20, 0].all()
    assert (~tkeep[:, 1]).sum() > 0            # a second choice overflows
    assert _rel(ty, jy) <= TOL[dtype, "prefill"]
    assert abs(taux - jaux) <= 1e-6 * abs(jaux)


def test_moe_ties_take_the_lower_expert():
    """A zero router makes every probability 1/E: both packages take
    experts 0..k-1, each token, with gates 1/k."""
    x = np.random.default_rng(3).normal(size=(B, S, 64)).astype(np.float32)
    jy, jaux, ty, taux, (jtop, _), (ttop, _) = _block_case(
        "olmoe-1b-7b", "float32", x, edit=np.zeros_like)
    want = np.tile(np.arange(2), (B * S, 1))
    np.testing.assert_array_equal(jtop, want)
    np.testing.assert_array_equal(ttop, want)
    assert _rel(ty, jy) <= TOL["float32", "prefill"]
    assert taux == pytest.approx(jaux, rel=1e-6)


def test_capacity_is_the_reference_rule():
    cfg = get_config("olmoe-1b-7b")
    assert TMoE.capacity(4096, cfg) == 640     # the full-width prefill
    assert TMoE.capacity(4104, cfg) == 641
    assert TMoE.capacity(8, cfg) == 8          # a decode step: dropless
    assert TMoE.capacity(3, cfg) == 3
    assert TMoE.capacity(40, _cfgs("olmoe-1b-7b",
                                   moe_capacity_factor=1.0)[1]) == 20
