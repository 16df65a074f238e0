"""The port's training forward and backward (``repro_torch.models``)
against the JAX package's, on the same weights and data.

Weights come from JAX's ``init_params`` with a seed and cross through
``params_from_numpy``; gradients come back through ``params_to_numpy``;
data are numpy arrays from a seed.  Tolerances, as a share of the JAX
value's max |.| (per gradient leaf):

- the blockwise attention's backward (``_flash``, an autograd Function)
  against ``jax.vjp`` of the reference's custom_vjp: 1e-5 in f32 (both sum
  the same blocks in f32, in other orders), 2e-2 for bf16 inputs (the
  gradients are rounded to bf16);
- ``chunked_ce_loss``, value and gradients, f32: 1e-6;
- ``forward_loss`` and every parameter's gradient at ``reduced()``:
  f32 params 1e-6 for the loss and 1e-5 for the gradients; bf16 params
  1e-4 for the loss and 3e-2 for the gradients (XLA and PyTorch round
  the bf16 matmul outputs and the embedding's scatter-add in other orders;
  measured 1.0e-2 at most);
- the remat policies: the same gradient bits.

Also: the blockwise backward saves no probability block; ``"dots"``
recomputes no projection matmul; ``params_to_numpy`` inverts
``params_from_numpy``; the train CLI runs on the CPU.

The cases are split over this file and ``test_torch_train_grads.py``, so
that xdist's ``--dist loadfile`` can run them on several workers; those
files import their helpers from here.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402

from repro.models import layers as JL                         # noqa: E402
from repro.models import model as JM                          # noqa: E402
from repro_torch.models import layers as TL                   # noqa: E402
from repro_torch.models import model as TM                    # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("stablelm-1.6b", "granite-8b", "h2o-danube-1.8b")
LOSS_TOL = {"float32": 1e-6, "bfloat16": 1e-4}
GRAD_TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _t(a, **kw):
    return torch.tensor(np.array(a), **kw)


def _f32(a):
    """A numpy leaf as f32; uint16 leaves are bf16 bits."""
    a = np.asarray(a)
    if a.dtype == np.uint16:
        return (a.astype(np.uint32) << 16).view(np.float32)
    return a.astype(np.float32)


def _rel(got, want):
    got, want = _f32(got), _f32(want)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


# ---------------------------------------------------------------------------
# the blockwise attention's backward
# ---------------------------------------------------------------------------

FLASH_CASES = {
    # name: (Sq, Sk, causal, window, dtype)
    "causal": (32, 32, True, 0, "float32"),
    "swa_window": (40, 40, True, 7, "float32"),
    "ragged_q_blocks": (37, 37, True, 0, "float32"),
    "not_causal_cross": (21, 45, False, 0, "float32"),
    "bf16": (37, 37, True, 5, "bfloat16"),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_backward_matches_jax_vjp(case):
    """dq, dk, dv (and out) of ``_flash`` against ``jax.vjp`` of the
    reference's ``_flash`` at q_block 8, kv_block 16; queries at positions
    Sk - Sq .. Sk - 1 with one that sees no key (position -1).  Not causal,
    the reference's ``_flash`` lets the keys that pad Sk to whole kv blocks
    through (``test_torch_flash_padding.py`` pins it), so there the
    reference is ``jax.vjp`` of its direct path."""
    Sq, Sk, causal, window, dtype = FLASH_CASES[case]
    rng = np.random.default_rng(len(case))
    B, NH, dh = 2, 4, 16
    q, k, v = (rng.normal(size=(B, s, NH, dh)).astype(np.float32)
               for s in (Sq, Sk, Sk))
    do = rng.normal(size=(B, Sq, NH, dh)).astype(np.float32)
    pq = np.tile(np.arange(Sk - Sq, Sk, dtype=np.int32), (B, 1))
    pq[1, 0] = -1
    pk = np.tile(np.arange(Sk, dtype=np.int32), (B, 1))
    jdt = jnp.dtype(dtype)
    jq, jk, jv, jdo = (jnp.asarray(a).astype(jdt) for a in (q, k, v, do))
    if causal:
        def reference(a, b, c):
            return JL._flash(a, b, c, pq, pk, causal, window, 8, 16)
    else:
        def reference(a, b, c):
            return JL.attention(a, b, c, pq, pk, causal=False, window=window,
                                q_block=Sq, kv_block=Sk)
    out, vjp = jax.vjp(reference, jq, jk, jv)
    want = (out,) + vjp(jdo)
    tdt = getattr(torch, dtype)
    tq, tk, tv = (_t(a).to(tdt).requires_grad_() for a in (q, k, v))
    tout = TL._flash(tq, tk, tv, _t(pq), _t(pk), causal, window, 8, 16)
    tout.backward(_t(do).to(tdt))
    tol = 1e-5 if dtype == "float32" else 2e-2
    for name, got, w in zip(("out", "dq", "dk", "dv"),
                            (tout, tq.grad, tk.grad, tv.grad), want):
        assert got.dtype == tdt, name
        assert _rel(got.detach().float().numpy(),
                    np.asarray(w.astype(jnp.float32))) <= tol, name


def test_gqa_attention_backward_matches_jax():
    """Through ``attention``: KV heads repeated to the query heads before
    the blockwise path, whose gradients the repeat sums back (GQA)."""
    rng = np.random.default_rng(11)
    B, S, NH, KV, dh = 2, 40, 4, 2, 16
    q = rng.normal(size=(B, S, NH, dh)).astype(np.float32)
    k, v = (rng.normal(size=(B, S, KV, dh)).astype(np.float32)
            for _ in range(2))
    do = rng.normal(size=(B, S, NH, dh)).astype(np.float32)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    kw = dict(causal=True, window=0, q_block=8, kv_block=16)
    _, vjp = jax.vjp(lambda a, b, c: JL.attention(a, b, c, pos, pos, **kw),
                     q, k, v)
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    TL.attention(tq, tk, tv, _t(pos), _t(pos), **kw).backward(_t(do))
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        assert got.shape == w.shape
        assert _rel(got.numpy(), w) <= 1e-5


def test_flash_backward_saves_no_probability_block():
    """What autograd keeps for the blockwise path is (q, k, v, positions,
    out, lse): no (B, NH, q_block, kv_block) block, however many there
    are."""
    B, S, NH, dh = 2, 64, 4, 16
    q, k, v = (torch.randn(B, S, NH, dh, requires_grad=True)
               for _ in range(3))
    pos = torch.arange(S, dtype=torch.int32).expand(B, S)
    saved = []

    def pack(t):
        saved.append(t.numel())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = TL._flash(q, k, v, pos, pos, True, 0, 8, 16)
    operands = 4 * q.numel() + 2 * pos.numel() + B * NH * S
    assert sum(saved) == operands
    out.sum().backward()
    assert q.grad is not None and k.grad is not None and v.grad is not None


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------


def test_chunked_ce_loss_matches_jax():
    """S = 20 in chunks of 8 (4 padded positions), labels with -1 in the
    middle and at the end; the loss, the count and the gradients in x and
    the head."""
    rng = np.random.default_rng(3)
    B, S, D, V = 2, 20, 12, 50
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    head = rng.normal(size=(D, V)).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    labels[0, 3:9] = -1
    labels[1, -2:] = -1
    (jl, jn), jg = jax.value_and_grad(
        lambda a, b: JM.chunked_ce_loss(a, b, labels, chunk=8),
        argnums=(0, 1), has_aux=True)(x, head)
    tx, th = _t(x).requires_grad_(), _t(head).requires_grad_()
    tl, tn = TM.chunked_ce_loss(tx, th, _t(labels), chunk=8)
    tl.backward()
    assert tn.dtype == torch.int32 and int(tn) == int(jn) == 2 * S - 8
    assert abs(float(tl.detach()) - float(jl)) <= 1e-6 * abs(float(jl))
    assert _rel(tx.grad.numpy(), jg[0]) <= 1e-6
    assert _rel(th.grad.numpy(), jg[1]) <= 1e-6
