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
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode    # noqa: E402

from repro.checkpoint import checkpoint as JC                 # noqa: E402
from repro.configs import get_config as jget_config           # noqa: E402
from repro.models import model as JM                          # noqa: E402
from repro.models import moe as JMoE                          # noqa: E402
from repro.optim.adamw import adamw_init as jadamw_init       # noqa: E402
from repro_torch import pytree                                # noqa: E402
from repro_torch.checkpoint import checkpoint as TC           # noqa: E402
from repro_torch.configs import get_config                    # noqa: E402
from repro_torch.launch import serve as TS                    # noqa: E402
from repro_torch.launch.train import _state_tree, train_loop  # noqa: E402
from repro_torch.models import model as TM                    # noqa: E402
from repro_torch.models import moe as TMoE                    # noqa: E402
from repro_torch.optim.adamw import AdamWState, adamw_init    # noqa: E402

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


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


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


def _batch(cfg, n, seed):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, (B, n + 1),
                                                dtype=np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :5] = -1
    return {"tokens": toks[:, :-1], "labels": labels}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_grads_match_jax(arch, dtype):
    """``forward_loss`` at S = 24 (the load-balance loss at 0.01 / layer
    in the total), its metrics, and every parameter's gradient (the
    router's and the experts' included) against ``jax.value_and_grad``."""
    jcfg, jp, tp = _models(arch, dtype, seed=7)
    cfg = tp.cfg
    batch = _batch(cfg, 24, seed=8)
    (jl, jm), jg = jax.value_and_grad(JM.forward_loss, has_aux=True)(
        jp, batch, jcfg)
    tp.requires_grad_(True)
    tl, tm = TM.forward_loss(tp, {k: _t(v) for k, v in batch.items()}, cfg)
    tl.backward()
    assert abs(float(tl.detach()) - float(jl)) <= LOSS_TOL[dtype] * abs(float(jl))
    aux = float(tm["aux"].detach())
    assert aux == pytest.approx(float(jm["aux"]), rel=LOSS_TOL[dtype])
    assert aux > 0
    assert float(tl.detach()) == pytest.approx(
        float(tm["ce"].detach()) + 0.01 * aux / cfg.n_layers, rel=1e-6)
    assert int(tm["tokens"]) == int(jm["tokens"]) == 2 * 24 - 5
    grads = TM.params_to_numpy(pytree.tree_map(lambda p: p.grad,
                                               TM.param_tree(tp)))
    assert jax.tree.structure(grads) == jax.tree.structure(jg)
    for path, got, want in zip(pytree.paths(grads), jax.tree.leaves(grads),
                               jax.tree.leaves(jg)):
        assert got.shape == want.shape, path
        assert _rel(got, want) <= GRAD_TOL[dtype], path


class _CountMatmuls(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = self.bmm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.mm += 1
        elif func == torch.ops.aten.bmm.default:
            self.bmm += 1
        return func(*args, **(kwargs or {}))


def test_dots_policy_saves_no_bmm():
    """Under ``remat="dots"`` the backward reruns no ``mm`` (the
    projections, the router, the dense residual: their outputs are kept)
    but reruns the batched products, the experts' three among them, as
    JAX's ``dots_with_no_batch_dims_saveable``; the gradients are the
    bits of ``remat="none"``."""
    base = get_config("arctic-480b").reduced()
    batch = {k: _t(v) for k, v in _batch(base, 24, seed=9).items()}
    seen = {}
    for remat in ("none", "dots"):
        cfg = dataclasses.replace(base, remat=remat, param_dtype="float32")
        tp = TM.init_params(cfg, 5, device="cpu").requires_grad_(True)
        loss, _ = TM.forward_loss(tp, batch, cfg)
        with _CountMatmuls() as counter:
            loss.backward()
        grads = [p.grad for p in pytree.leaves(TM.param_tree(tp))]
        seen[remat] = (loss.detach(), grads, counter)
    (l0, g0, c0), (l1, g1, c1) = seen["none"], seen["dots"]
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert c1.mm == c0.mm
    assert c1.bmm >= c0.bmm + 3 * base.n_layers


def test_init_params_moe_shapes_and_scales():
    cfg = get_config("arctic-480b").reduced()
    a = TM.init_params(cfg, 0, device="cpu")
    p = a.blocks[0].p
    E, D, F = cfg.moe_experts, cfg.d_model, cfg.d_ff
    assert p["router"].shape == (D, E) and p["router"].dtype == torch.float32
    assert p["we_gate"].shape == (E, D, F) and p["we_down"].shape == (E, F, D)
    assert p["we_up"].dtype == torch.bfloat16
    assert p["w_gate"].shape == (D, F)             # the dense residual
    assert "w_gate" not in TM.init_params(
        get_config("olmoe-1b-7b").reduced(), 0, device="cpu").blocks[0].p
    so = 0.02 / (2 * cfg.n_layers) ** 0.5
    assert abs(float(p["we_down"].float().std()) - so) < 0.1 * so
    assert abs(float(p["router"].std()) - 0.02) < 2e-3
    n = sum(w.numel() for w in a.parameters())
    assert n == cfg.param_count() + cfg.d_model     # + final_norm


# ---------------------------------------------------------------------------
# checkpoints and the command lines
# ---------------------------------------------------------------------------


def _bits(a):
    a = np.asarray(a)
    return a.view({1: np.int8, 2: np.int16, 4: np.int32, 8: np.int64}[
        a.itemsize])


def test_moe_checkpoint_crosses_both_packages(tmp_path):
    """The port's training checkpoint of reduced olmoe-1b-7b (2 steps),
    restored by JAX into its (params, AdamWState) template, leaf for leaf
    under JAX's paths (``blocks/router``, ``blocks/we_gate``, ...), bit for
    bit; and a JAX checkpoint of its own initial state restored by the
    port into its template, bit for bit."""
    jcfg, cfg = _cfgs("olmoe-1b-7b")
    port_dir = str(tmp_path / "port")
    out = train_loop(cfg, steps=2, global_batch=2, seq_len=16,
                     ckpt_dir=port_dir, ckpt_every=100, device="cpu",
                     log_every=0)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    (jp, jopt), extra = JC.restore_checkpoint(
        port_dir, (jparams, jadamw_init(jparams)))
    assert extra["data_step"] == 2
    opt = out["opt_state"]
    want = (jax.tree.leaves(TM.params_to_numpy(out["params"]))
            + [opt.step.numpy()]
            + jax.tree.leaves(TM.params_to_numpy(opt.m))
            + jax.tree.leaves(TM.params_to_numpy(opt.v)))
    got = jax.tree.leaves((jp, jopt))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.asarray(g).shape == w.shape
        assert np.array_equal(_bits(g), _bits(w))
    assert "blocks" in jp and {"router", "we_gate", "we_up", "we_down"} <= \
        set(jp["blocks"])

    jax_dir = str(tmp_path / "jax")
    jstate = (jparams, jadamw_init(jparams))
    JC.save_checkpoint(jax_dir, 1, jstate, extra={"data_step": 1})
    tp = TM.init_params(cfg, 1, device="cpu")
    tree = TM.param_tree(tp)
    template = _state_tree(tree, adamw_init(tree), "meta")
    (p_st, o_st), _ = TC.restore_checkpoint(jax_dir, template, device="cpu")
    assert isinstance(o_st, AdamWState)
    got = pytree.leaves((p_st, o_st))
    assert len(got) == len(jax.tree.leaves(jstate))
    for g, w in zip(got, jax.tree.leaves(jstate)):
        g = g.view(torch.int16) if g.dtype == torch.bfloat16 else g
        assert np.array_equal(_bits(g.numpy()), _bits(w))


def _run(module, *args):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-m", module, *args], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def test_serve_and_train_clis_run_olmoe_on_the_cpu():
    out = _run("repro_torch.launch.serve", "--arch", "olmoe-1b-7b",
               "--reduced", "--device", "cpu", "--calibrate")
    assert "generated (4, 16)" in out and "exact p99.9 scale" in out
    out = _run("repro_torch.launch.train", "--arch", "olmoe-1b-7b",
               "--reduced", "--device", "cpu", "--steps", "3",
               "--global-batch", "2", "--seq-len", "16")
    assert "done: 3 steps" in out
