"""The blockwise attention's padded keys when it is not causal.

``_flash`` pads the keys to whole ``kv_block``s at position 2^30.  The
causal mask drops them; a non-causal mask (the encoder's, the
cross-attention's) would not, and the zero keys would take softmax weight.
The port masks every key past the Sk real ones (``layers._block_bias``),
so its blockwise answer and gradients are its direct path's.  The
reference's ``_flash`` does not: its non-causal answer differs from its
direct path whenever Sk is not a multiple of ``kv_block`` (pinned here by
name; the JAX package is not changed).

Shapes: B = 2, Sq = Sk = 40, 2 heads of 8, q_block 16, kv_block 32 (so Sk
pads to 64), f32 from numpy seeds; tolerance 1e-5 of max |.|.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402

from repro.models import layers as JL                         # noqa: E402
from repro_torch.models import layers as TL                   # noqa: E402

B, S, NH, DH, QB, KB = 2, 40, 2, 8, 16, 32


def _inputs(seed):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.normal(size=(B, S, NH, DH)).astype(np.float32)
                   for _ in range(4))
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    return q, k, v, do, pos


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("causal", [False, True])
def test_port_blockwise_equals_its_direct_path(causal):
    """``_flash`` (3 q blocks x 2 kv blocks, the second half padding)
    against ``attention``'s direct path on the same inputs: the output and
    the q, k, v gradients within 1e-5."""
    q, k, v, do, pos = _inputs(1)
    assert S * S > 2 * QB * KB and S % KB

    def run(fn):
        tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
        out = fn(tq, tk, tv)
        out.backward(torch.from_numpy(do))
        return [t.detach().numpy() for t in (out, tq.grad, tk.grad, tv.grad)]

    pt = torch.from_numpy(pos)
    blockwise = run(lambda a, b, c: TL._flash(a, b, c, pt, pt, causal, 0, QB,
                                              KB))
    direct = run(lambda a, b, c: TL.attention(a, b, c, pt, pt, causal=causal,
                                              q_block=S, kv_block=S))
    for name, got, want in zip(("out", "dq", "dk", "dv"), blockwise, direct):
        assert _rel(got, want) <= 1e-5, name


def test_reference_flash_lets_padded_keys_through_when_not_causal():
    """The reference's ``_flash(causal=False)`` is more than 0.1 of max
    |out| off its direct path here (the 24 zero keys of the padded kv
    block take softmax weight); causal, it agrees within 1e-5.  The port's
    answer is the direct path's in both cases."""
    q, k, v, _, pos = _inputs(2)
    for causal, off in ((False, True), (True, False)):
        blockwise = JL._flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              pos, pos, causal, 0, QB, KB)
        direct = JL.attention(q, k, v, pos, pos, causal=causal, q_block=S,
                              kv_block=S)
        err = _rel(blockwise, direct)
        assert (err > 0.1) if off else (err <= 1e-5), (causal, err)
        pt = torch.from_numpy(pos)
        port = TL._flash(*(torch.from_numpy(a) for a in (q, k, v)), pt, pt,
                         causal, 0, QB, KB)
        assert _rel(port.numpy(), direct) <= 1e-5, causal


def test_padded_key_mask_keeps_causal_bits():
    """``_block_bias`` adds the padding mask only where the causal mask
    already drops those keys, so a causal block's bias, and with it every
    causal result, keeps its bits; not causal, only the padded keys
    change."""
    pos = torch.arange(S, dtype=torch.int32).expand(B, S)
    pk = torch.nn.functional.pad(pos, (0, 2 * KB - S), value=TL.UNWRITTEN)
    for causal in (True, False):
        for j in range(2):
            ks = slice(j * KB, (j + 1) * KB)
            plain = TL._mask_bias(pos[:, :QB], pk[:, ks], None, causal, 0)
            got = TL._block_bias(pos[:, :QB], pk[:, ks], S, j, KB, causal, 0)
            real = min(KB, S - j * KB)
            assert torch.equal(got[..., :real], plain[..., :real])
            assert (got[..., real:] == TL.NEG_INF).all()
            if causal:
                assert torch.equal(got, plain)
