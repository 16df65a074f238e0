"""The port's AdamW (``repro_torch.optim.adamw``) against the JAX
package's, from the same numpy parameters, gradients and state.

The exact quantiles compare as raw bits: the clip threshold and the int8
compression scale each step, and the int8 leaves themselves.  The rest is
f32 arithmetic in another order (the global norm sums its leaves in
another order, and XLA fuses multiply-adds), so after 5 steps params, m and
v each lie within 8 ulps of their leaf's largest magnitude (measured 3 at
most; an element's own ulps would mislead where m cancels near zero), and
the gradient norm within 1e-6 of itself.  The reference's own AdamW tests
run here on the port too.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402
import ml_dtypes                                              # noqa: E402

from repro.optim import adamw as JA                           # noqa: E402
from repro_torch import pytree                                # noqa: E402
from repro_torch.optim import adamw as TA                     # noqa: E402

CONFIGS = {
    "quantile_clip": dict(quantile_clip=0.999),
    "compress_int8": dict(quantile_clip=0.999, compress_bits=8),
    "no_clip": dict(quantile_clip=0.0, grad_clip_norm=0.0, warmup_steps=1),
    "tight_clips": dict(quantile_clip=0.9, grad_clip_norm=0.05,
                        warmup_steps=3),
}


def _tree(rng):
    """A tree shaped as a stacked parameter tree, with bf16 and f32
    leaves."""
    return {"blocks": {"w": (rng.normal(size=(2, 8, 6)) * 0.02
                             ).astype(np.float32),
                       "ln": np.ones((2, 8), np.float32)},
            "embed": (rng.normal(size=(30, 8)) * 0.02
                      ).astype(ml_dtypes.bfloat16),
            "head": (rng.normal(size=(8, 30)) * 0.02).astype(np.float32)}


def _grads(rng, like):
    """Gradients over four decades of magnitude."""
    return jax.tree.map(
        lambda a: (rng.standard_normal(a.shape)
                   * 10 ** rng.uniform(-4, -1, a.shape)).astype(a.dtype),
        like)


def _t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _np(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _bits(a):
    a = np.asarray(a)
    return a.view({1: np.int8, 2: np.int16, 4: np.int32}[a.itemsize])


def _close(got, want, ulps=8):
    """Within ``ulps`` units in the last place of the leaf's largest
    magnitude, in the leaf's own dtype."""
    for g, w in zip(pytree.leaves(got), jax.tree.leaves(want)):
        w = np.asarray(w)
        ulp = np.spacing(np.float32(np.abs(w.astype(np.float32)).max()))
        if w.dtype.name == "bfloat16":
            ulp *= 2 ** 16                     # 7 mantissa bits, not 23
        diff = np.abs(_np(g).astype(np.float32) - w.astype(np.float32))
        assert diff.max() <= ulps * ulp


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_adamw_update_matches_jax(name):
    rng = np.random.default_rng(len(name))
    p0 = _tree(rng)
    jcfg, tcfg = JA.AdamWConfig(**CONFIGS[name]), TA.AdamWConfig(
        **CONFIGS[name])
    jp = jax.tree.map(jnp.asarray, p0)
    jst = JA.adamw_init(jp)
    tp = pytree.tree_map(_t, p0)
    tst = TA.adamw_init(tp)
    update = jax.jit(lambda g, s, p: JA.adamw_update(g, s, p, jcfg))
    for step in range(5):
        g = _grads(rng, p0)
        jp, jst, jm = update(jax.tree.map(jnp.asarray, g), jst, jp)
        tp, tst, tm = TA.adamw_update(pytree.tree_map(_t, g), tst, tp, tcfg)
        assert set(tm) == set(jm)
        for key in ("clip_threshold", "compress_scale"):
            if key in jm:
                assert tm[key].dtype == torch.float32
                assert np.array_equal(_bits(tm[key].numpy()),
                                      _bits(jm[key])), (step, key)
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) \
            <= 1e-6 * float(jm["grad_norm"])
        assert tst.step.dtype == torch.int32
        assert int(tst.step) == int(jst.step) == step + 1
        _close(tp, jp)
        _close(tst.m, jst.m)
        _close(tst.v, jst.v)
    for leaf, want in zip(pytree.leaves(tp), jax.tree.leaves(jp)):
        assert _np(leaf).dtype == want.dtype


def test_adamw_writes_into_the_given_tensors():
    """The update lands in the parameter and moment tensors it was given
    (as the reference's donated buffers), and leaves the gradients."""
    params = {"w": torch.tensor([2.0, -3.0, 1.5])}
    state = TA.adamw_init(params)
    grads = {"w": torch.tensor([1.0, 1.0, -1.0])}
    before = grads["w"].clone()
    w, m = params["w"], state.m["w"]
    new, state2, _ = TA.adamw_update(grads, state, params,
                                     TA.AdamWConfig(quantile_clip=0.5))
    assert new["w"] is w and state2.m["w"] is m
    assert not torch.equal(w, torch.tensor([2.0, -3.0, 1.5]))
    assert torch.equal(grads["w"], before)
    assert int(state.step) == 0 and int(state2.step) == 1


@pytest.mark.parametrize("seed", [0, 1])
def test_compress_int8_matches_jax(seed):
    """The int8 leaves equal JAX's, the scale is the same bits, and the
    decompressed tree too."""
    rng = np.random.default_rng(seed)
    g = {"a": (rng.normal(size=(37, 5)) * 0.01).astype(np.float32),
         "b": [(rng.normal(size=301) * 0.1).astype(ml_dtypes.bfloat16)]}
    jq, js = JA.compress_int8(jax.tree.map(jnp.asarray, g))
    tq, ts = TA.compress_int8(pytree.tree_map(_t, g))
    assert np.array_equal(_bits(ts.numpy()), _bits(js))
    for got, want in zip(pytree.leaves(tq), jax.tree.leaves(jq)):
        assert got.dtype == torch.int8
        assert np.array_equal(got.numpy(), np.asarray(want))
    for got, want in zip(pytree.leaves(TA.decompress_int8(tq, ts)),
                         jax.tree.leaves(JA.decompress_int8(jq, js))):
        assert np.array_equal(_bits(got.numpy()), _bits(want))


def test_step_decreases_loss_quadratic():
    params = {"w": torch.tensor([2.0, -3.0, 1.5])}
    cfg = TA.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=1,
                         quantile_clip=0.0, grad_clip_norm=0.0)
    st = TA.adamw_init(params)
    for _ in range(200):
        g = {"w": 2 * params["w"]}
        params, st, _ = TA.adamw_update(g, st, params, cfg)
    assert float(params["w"].abs().max()) < 0.1


def test_int8_roundtrip():
    rng = np.random.default_rng(3)
    g = {"w": torch.from_numpy(rng.normal(size=4096).astype(np.float32)
                               * 0.01)}
    q8, scale = TA.compress_int8(g)
    rec = TA.decompress_int8(q8, scale)
    ga, ra = g["w"].numpy(), rec["w"].numpy()
    inside = np.abs(ga) <= float(scale)       # the 99.9% within the scale
    assert np.abs(ra[inside] - ga[inside]).max() <= float(scale) / 127 + 1e-9
    assert np.abs(ra[~inside]).max() <= float(scale) * (1 + 1e-6)
    assert q8["w"].dtype == torch.int8
