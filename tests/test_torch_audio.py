"""The port's encoder-decoder (audio) family against the JAX package's, on
the same weights: the cross-attention block, the weights both ways,
``init_params`` and the serve CLI.

Weights come from JAX's ``init_params`` with a seed and cross through
``params_from_numpy``; prompts, frames and activations are numpy arrays
from a seed.  Covered at ``reduced()`` seamless-m4t-large-v2 (2 encoder +
2 decoder layers, d 64, 4 heads over 2 KV heads of 16, GELU, vocab 256,
the encoder over the batch's ``frames``).  Tolerances, a share of JAX's
max |.|, those of ``test_torch_models.py`` and ``test_torch_ssm.py``:

- f32 params: layers and prefill 1e-5; decode 1e-3 (the decode attention,
  self and cross, takes q, the cache and the probabilities to bf16 in
  both packages); bf16 params 2e-2;
- ``forward_loss``: f32 1e-6, bf16 1e-4; gradients f32 1e-5, bf16 3e-2;
- weights and checkpoints: bit for bit.

The cases are split over this file and ``test_torch_audio_model.py``, so
that xdist's ``--dist loadfile`` can run them on several workers; that
file imports its helpers from here.
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
ARCH = "seamless-m4t-large-v2"
DTYPES = ("float32", "bfloat16")
B = 2
TOL = {("float32", "prefill"): 1e-5, ("float32", "decode"): 1e-3,
       ("bfloat16", "prefill"): 2e-2, ("bfloat16", "decode"): 2e-2}
LOSS_TOL = {"float32": 1e-6, "bfloat16": 1e-4}
GRAD_TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _cfgs(dtype="float32", **kw):
    return (dataclasses.replace(jget_config(ARCH).reduced(), param_dtype=dtype,
                                **kw),
            dataclasses.replace(get_config(ARCH).reduced(), param_dtype=dtype,
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


def _models(dtype, seed=0, **kw):
    jcfg, cfg = _cfgs(dtype, **kw)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    tp = TM.params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                              device="cpu")
    return jcfg, jp, tp


def _frames(cfg, n, seed):
    return np.random.default_rng(seed).normal(
        size=(B, n, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_attn_block_matches_jax(dtype):
    """A decoder layer's cross-attention leaves through ``attn_block(xkv=,
    causal=False)``: K/V from the encoder's output, no rope, keys at
    0..Sf-1; S = 20 queries over 5 frames (the direct path) and 64 over
    64 (the blockwise path)."""
    jcfg, jp, tp = _models(dtype, seed=3)
    cfg = tp.cfg
    jlp = {k[:-2]: v[0] for k, v in jp["dec_blocks"].items()
           if k.endswith("_c")}
    tlp = {k[:-2]: v for k, v in tp.dec_blocks[0].p.items()
           if k.endswith("_c")}
    rng = np.random.default_rng(4)
    for S, Sf in ((20, 5), (64, 64)):
        x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
        enc = rng.normal(size=(B, Sf, cfg.d_model)).astype(np.float32)
        pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
        jdt = jnp.dtype(dtype)
        want, _ = jax.jit(lambda p, a, e, n: JL.attn_block(
            p, a, jcfg, positions=n, causal=False, xkv=e))(
                jlp, jnp.asarray(x).astype(jdt), jnp.asarray(enc).astype(jdt),
                pos)
        tdt = getattr(torch, dtype)
        got, cache = TL.attn_block(tlp, _t(x).to(tdt), cfg,
                                   positions=_t(pos), causal=False,
                                   xkv=_t(enc).to(tdt))
        assert cache is None and got.dtype == tdt
        assert _rel(_np(got), want) <= TOL[dtype, "prefill"], (S, Sf)


def test_params_from_numpy_is_bit_exact_and_params_to_numpy_inverts_it():
    """JAX's tree {dec_blocks, embed, enc_blocks, enc_norm, final_norm,
    head} into the port (bf16 leaves as ml_dtypes arrays or their uint16
    bits) and back, bit for bit, under the same paths."""
    jcfg, jp, tp = _models("bfloat16", seed=5)
    tree = jax.tree.map(np.asarray, jp)
    assert sorted(tree) == ["dec_blocks", "embed", "enc_blocks", "enc_norm",
                            "final_norm", "head"]
    assert {"ln_c", "wq_c", "wk_c", "wv_c", "wo_c"} <= set(tree["dec_blocks"])
    assert "wq_c" not in tree["enc_blocks"]
    bits = jax.tree.map(lambda a: a.view(np.uint16)
                        if a.dtype.name == "bfloat16" else a, tree)
    tp2 = TM.params_from_numpy(tp.cfg, bits, device="cpu")
    back = TM.params_to_numpy(tp2)
    assert pytree.paths(back) == [jax.tree_util.keystr(k) for k, _ in
                                  jax.tree_util.tree_leaves_with_path(tree)]
    for path, got, want in zip(pytree.paths(back), pytree.leaves(back),
                               jax.tree.leaves(tree)):
        assert got.shape == want.shape, path
        assert np.array_equal(_bits(got), _bits(want)), path
    np.testing.assert_array_equal(
        _bits(tp2.dec_blocks[1].p["wk_c"].view(torch.int16).numpy()),
        _bits(tree["dec_blocks"]["wk_c"][1]))
    assert len(tp2.enc_blocks) == tp2.cfg.enc_layers == 2
    with pytest.raises(ValueError):
        TM.params_from_numpy(tp.cfg, {k: v for k, v in tree.items()
                                      if k != "enc_norm"}, device="cpu")


def test_init_params_gives_the_encdec_leaves_their_scales():
    """Seeded, with the reference's scales: ``wo`` and ``wo_c`` at 0.02 /
    sqrt(2 (n_layers + enc_layers)), the other matmuls at 0.02, ``ln_c``
    and ``enc_norm`` ones.  The tensors hold the reference's leaves: the
    formula of ``param_count`` leaves the cross leaves and the norms out,
    in both packages."""
    cfg = get_config(ARCH).reduced()
    tp = TM.init_params(cfg, 0, device="cpu")
    again = TM.init_params(cfg, 0, device="cpu")
    assert torch.equal(tp.dec_blocks[1].p["wq_c"], again.dec_blocks[1].p["wq_c"])
    so = 0.02 / (2 * (cfg.n_layers + cfg.enc_layers)) ** 0.5
    d = tp.dec_blocks[-1].p
    for name in ("wo", "wo_c"):
        assert abs(float(d[name].float().std()) - so) < 0.1 * so, name
    for name in ("wq_c", "wk_c", "wv_c"):
        assert abs(float(d[name].float().std()) - 0.02) < 2e-3, name
        assert d[name].dtype == torch.bfloat16
    assert (d["ln_c"] == 1).all() and d["ln_c"].dtype == torch.float32
    assert (tp.p["enc_norm"] == 1).all()
    assert abs(float(tp.enc_blocks[0].p["wo"].float().std()) - so) < 0.1 * so
    D, NH, KV, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    cross = D + 2 * D * NH * dh + 2 * D * KV * dh
    n = sum(w.numel() for w in tp.parameters())
    assert n == cfg.param_count() + 2 * D + cfg.n_layers * cross
    jshapes = jax.eval_shape(lambda: JM.init_params(
        jget_config(ARCH).reduced(), jax.random.PRNGKey(0)))
    assert n == sum(a.size for a in jax.tree.leaves(jshapes))


def test_serve_cli_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--reduced", "--device", "cpu", "--calibrate"], env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "generated (4, 16)" in proc.stdout
    assert "exact p99.9 scale" in proc.stdout
