"""The port's vlm family (M-RoPE in ``repro_torch.models.layers``, the
patch projection and ``positions3`` of ``models.model``) against the JAX
package's, on the same weights.

Weights come from JAX's ``init_params`` with a seed and cross through
``params_from_numpy``; inputs are numpy arrays from a seed.  Covered at
``reduced()``: qwen2-vl-2b (M-RoPE sections (2, 3, 3), 8 patch positions).
The patches sit on a 2 x 4 grid, positions3 (0, i // 4, i % 4), and text
position j after them is (j, j, j), so a decode step's broadcast of
``cache_len`` carries on from the prompt, as the reference's does.
Tolerances, as in ``test_torch_models.py``, a share of JAX's max |.|:

- M-RoPE and the attention block: f32 1e-6 (decode 1e-3), bf16 1e-2;
- prefill: f32 1e-5, bf16 2e-2; decode: f32 1e-3, bf16 2e-2;
- ``forward_loss`` and gradients, as ``test_torch_train.py``: the loss f32
  1e-6, bf16 1e-4; gradients f32 1e-5, bf16 3e-2;
- M-RoPE over equal streams against RoPE: the same bits.
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

from repro.configs import get_config as jget_config           # noqa: E402
from repro.models import layers as JL                         # noqa: E402
from repro.models import model as JM                          # noqa: E402
from repro_torch import pytree                                # noqa: E402
from repro_torch.configs import get_config                    # noqa: E402
from repro_torch.models import layers as TL                   # noqa: E402
from repro_torch.models import model as TM                    # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "qwen2-vl-2b"
B, S = 2, 20
TOL = {("float32", "prefill"): 1e-5, ("float32", "decode"): 1e-3,
       ("bfloat16", "prefill"): 2e-2, ("bfloat16", "decode"): 2e-2}
LOSS_TOL = {"float32": 1e-6, "bfloat16": 1e-4}
GRAD_TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _cfgs(dtype="float32"):
    return (dataclasses.replace(jget_config(ARCH).reduced(), param_dtype=dtype),
            dataclasses.replace(get_config(ARCH).reduced(), param_dtype=dtype))


def _f32(a):
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


def _models(dtype, seed=0):
    jcfg, cfg = _cfgs(dtype)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    tp = TM.params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                              device="cpu")
    return jcfg, jp, tp


def _positions3(n: int, patches: int, width: int) -> np.ndarray:
    """(3, B, n): patch i at (0, i // width, i % width), text j at (j, j,
    j)."""
    i = np.arange(n)
    p3 = np.stack([i, i, i]).astype(np.int32)
    p3[0, :patches] = 0
    p3[1, :patches] = i[:patches] // width
    p3[2, :patches] = i[:patches] % width
    return np.broadcast_to(p3[:, None], (3, B, n)).copy()


def _vision_batch(cfg, n, seed):
    rng = np.random.default_rng(seed)
    F = cfg.frontend_len
    toks = rng.integers(0, cfg.vocab, (B, n + 1), dtype=np.int32)
    return {"tokens": toks[:, :n],
            "patch_embeds": rng.normal(size=(B, F, cfg.d_model)
                                       ).astype(np.float32),
            "positions3": _positions3(n, F, 4)}, toks


# ---------------------------------------------------------------------------
# M-RoPE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mrope_matches_jax(dtype):
    """Three distinct position streams over sections (16, 24, 24) of
    d_head 128 and the reduced (2, 3, 3) of 16."""
    rng = np.random.default_rng(0)
    tol = 1e-6 if dtype == "float32" else 1e-2
    for dh, sections in ((128, (16, 24, 24)), (16, (2, 3, 3))):
        x = rng.normal(size=(B, 7, 3, dh)).astype(np.float32) * 3
        p3 = rng.integers(0, 5000, (3, B, 7)).astype(np.int32)
        jx = jnp.asarray(x).astype(dtype)
        tx = _t(x).to(getattr(torch, dtype))
        for theta in (10000.0, 1e6):
            got = TL.apply_mrope(tx, _t(p3), theta, sections)
            assert got.dtype == tx.dtype
            assert _rel(_np(got), JL.apply_mrope(jx, p3, theta, sections)) \
                <= tol, (dh, theta)
    with pytest.raises(ValueError):
        TL.mrope_angles(_t(p3), 16, 1e4, (2, 3, 4))


def test_mrope_text_equals_rope():
    """Equal streams give RoPE's angles and rotation bit for bit, as JAX's
    ``test_mrope_text_equals_rope``."""
    rng = np.random.default_rng(1)
    x = _t(rng.normal(size=(B, 9, 4, 16)).astype(np.float32))
    pos = _t(rng.integers(0, 3000, (B, 9)).astype(np.int32))
    p3 = pos.expand(3, B, 9)
    for a, b in zip(TL.mrope_angles(p3, 16, 1e4, (2, 3, 3)),
                    TL.rope_angles(pos, 16, 1e4)):
        assert torch.equal(a, b)
    assert torch.equal(TL.apply_mrope(x, p3, 1e4, (2, 3, 3)),
                       TL.apply_rope(x, pos, 1e4))


def test_attn_block_with_positions3_matches_jax():
    """One layer's attention sub-block with M-RoPE over a patch grid,
    writing its cache at slot 0, then one token at ``kv_len[0]`` with the
    broadcast stream (in place in the port)."""
    jcfg, jp, tp = _models("float32")
    cfg = tp.cfg
    lp = jax.tree.map(lambda a: a[0], jp["blocks"])
    rng = np.random.default_rng(2)
    x = rng.normal(size=(B, 10, cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(10, dtype=np.int32), (B, 1))
    p3 = _positions3(10, 8, 4)
    jc = {k: v[0] for k, v in JM.init_cache(jcfg, B, 12).items()}
    tc = {k: v[0] for k, v in TM.init_cache(cfg, B, 12, device="cpu").items()}
    jo, jc = JL.attn_block(lp, x, jcfg, positions=pos, positions3=p3,
                           cache=jc, kv_len=np.zeros(B, np.int32))
    to, _ = TL.attn_block(tp.blocks[0].p, _t(x), cfg, positions=_t(pos),
                          positions3=_t(p3), cache=tc,
                          kv_len=torch.zeros(B, dtype=torch.int32))
    assert _rel(to.numpy(), jo) <= 1e-6
    for leaf in ("k", "v"):
        assert _rel(tc[leaf].numpy(), jc[leaf]) <= 1e-6
    # the same block with RoPE over the plain positions differs
    plain, _ = TL.attn_block(tp.blocks[0].p, _t(x), cfg, positions=_t(pos))
    assert _rel(plain.numpy(), jo) > 1e-3
    x1 = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    p1 = np.full((B, 1), 10, np.int32)
    jo, jc = JL.attn_block(lp, x1, jcfg, positions=p1,
                           positions3=np.broadcast_to(p1[None], (3, B, 1)),
                           cache=jc, kv_len=np.full(B, 10, np.int32))
    to, _ = TL.attn_block(tp.blocks[0].p, _t(x1), cfg, positions=_t(p1),
                          positions3=_t(p1).expand(3, B, 1), cache=tc,
                          kv_len=torch.full((B,), 10, dtype=torch.int32))
    assert _rel(to.numpy(), jo) <= 1e-3
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def test_embed_inputs_project_the_patches():
    """``patch_embeds`` cast to the param dtype times ``patch_proj`` take
    the first F positions; without ``positions3`` an M-RoPE config gets
    the positions broadcast to 3 streams."""
    _, _, tp = _models("bfloat16")
    cfg = tp.cfg
    batch, _ = _vision_batch(cfg, S, seed=3)
    tb = {k: _t(v) for k, v in batch.items()}
    x, pos, p3 = TM._embed_inputs(tp.p, tb, cfg)
    F = cfg.frontend_len
    assert x.dtype == torch.bfloat16
    assert torch.equal(x[:, :F], tb["patch_embeds"].to(torch.bfloat16)
                       @ tp.p["patch_proj"])
    assert torch.equal(x[:, F:], tp.p["embed"][tb["tokens"][:, F:].long()])
    assert torch.equal(p3, tb["positions3"])
    _, pos, p3 = TM._embed_inputs(tp.p, {"tokens": tb["tokens"]}, cfg)
    assert p3.shape == (3, B, S) and all(torch.equal(s, pos) for s in p3)
    assert tp.p["patch_proj"].shape == (cfg.d_model, cfg.d_model)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(dtype):
    """Prefill of S = 20 (8 patch positions, a real positions3) into a
    cache of 26, then 3 decode steps; logits and every cache leaf each
    step."""
    jcfg, jp, tp = _models(dtype, seed=4)
    cfg, C = tp.cfg, S + 6
    batch, toks = _vision_batch(cfg, S + 3, seed=5)
    pre = {"tokens": batch["tokens"][:, :S],
           "patch_embeds": batch["patch_embeds"],
           "positions3": batch["positions3"][..., :S]}
    jl, jc = jax.jit(lambda p, b: JM.prefill(p, b, jcfg, cache_len=C))(jp, pre)
    tl, tc = TM.prefill(tp, {k: _t(v) for k, v in pre.items()}, cfg,
                        cache_len=C)
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_loss_and_grads_match_jax(dtype):
    """``forward_loss`` at S = 24 with patches (labels -1 over them, as the
    data pipeline gives) and positions3, and every parameter's gradient,
    ``patch_proj``'s included, against ``jax.value_and_grad``."""
    jcfg, jp, tp = _models(dtype, seed=6)
    cfg = tp.cfg
    batch, toks = _vision_batch(cfg, 24, seed=7)
    batch["labels"] = toks[:, 1:].copy()
    batch["labels"][:, :cfg.frontend_len] = -1
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: JM.forward_loss(p, b, jcfg), has_aux=True))(
            jp, jax.tree.map(jnp.asarray, batch))
    tp.requires_grad_(True)
    tl, tm = TM.forward_loss(tp, {k: _t(v) for k, v in batch.items()}, cfg)
    tl.backward()
    assert abs(float(tl.detach()) - float(jl)) <= LOSS_TOL[dtype] * abs(float(jl))
    assert int(tm["tokens"]) == int(jm["tokens"]) == B * (24 - 8)
    assert float(tm["aux"]) == float(jm["aux"]) == 0.0
    grads = TM.params_to_numpy(pytree.tree_map(lambda p: p.grad,
                                               TM.param_tree(tp)))
    assert jax.tree.structure(grads) == jax.tree.structure(jg)
    for path, got, want in zip(pytree.paths(grads), jax.tree.leaves(grads),
                               jax.tree.leaves(jg)):
        assert got.shape == want.shape, path
        assert _rel(got, want) <= GRAD_TOL[dtype], path
    assert np.abs(_f32(grads["patch_proj"])).max() > 0


def test_serve_cli_runs_qwen2_vl_on_the_cpu():
    """The serve CLI gives a vision_stub config zero patch embeddings."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--reduced", "--device", "cpu", "--calibrate"],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "generated (4, 16)" in proc.stdout
    assert "exact p99.9 scale" in proc.stdout
