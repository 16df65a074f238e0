"""The training loop of the ssm and hybrid families against the JAX
package's: reduced mamba2-1.3b and zamba2-2.7b (helpers:
``test_torch_family_train.py``); and the chunked scan's gradient where a
chunk's decay passes e^88."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402
from repro.models import ssm as JS                            # noqa: E402
from repro_torch.models import ssm as TS                      # noqa: E402

from test_torch_family_train import check_train_loop          # noqa: E402
from test_torch_ssm import _first_mamba, _models, _x          # noqa: E402


@pytest.mark.parametrize("arch", ("mamba2-1.3b", "zamba2-2.7b"))
def test_train_loop_losses_match_jax(arch, tmp_path):
    check_train_loop(arch, tmp_path)


def test_scan_gradient_past_an_overflowing_decay_is_finite():
    """Reduced mamba2-1.3b in f32, one layer with ``dt_bias`` 20 (dt ~ 20
    a step, A = -1): within a chunk of 8 the decay from a later position
    to an earlier one, e^(cum_t - cum_s) above the diagonal, passes e^88
    and overflows to inf.  The port masks that exponent before the exp:
    the chunked scan's output and its gradients in x and every weight are
    finite, and (but A_log's) within 1e-2 of max of the scan's at chunks
    of one position (no decay above a diagonal; the intra-chunk product
    rounds to bf16).
    The reference masks after the exp, and its gradients are NaN there
    (``ROADMAP.md`` Queue 3), though its output agrees with the port's."""
    jcfg, jp, tp = _models("mamba2-1.3b", "float32")
    cfg = tp.cfg
    jl, tl = _first_mamba(jp, tp)
    jl = {**jl, "dt_bias": jnp.full_like(jl["dt_bias"], 20.0)}
    with torch.no_grad():
        tl["dt_bias"].fill_(20.0)
    x = _x(16, cfg.d_model)

    def grads(c):
        """(y, the gradients of x and of every weight but the block's
        pre-norm, which ``MambaBlock`` runs, A_log's last)."""
        xx = torch.from_numpy(x).requires_grad_()
        names = [n for n in tl if n not in ("norm", "A_log")] + ["A_log"]
        for w in tl.values():
            w.requires_grad_(True)
            w.grad = None
        y = TS.ssd_forward(tl, xx, c)
        y.backward(torch.ones_like(y))
        out = [xx.grad] + [tl[n].grad for n in names]
        for w in tl.values():
            w.requires_grad_(False)
        return y.detach(), out

    y, got = grads(cfg)
    y_one, want = grads(dataclasses.replace(cfg, ssm_chunk=1))
    assert all(torch.isfinite(g).all() for g in [y, *got])
    assert float((y - y_one).abs().max()) <= 1e-2 * float(y_one.abs().max())
    # A_log's gradient is the e^-20 decay's (~1e-11, summed in other
    # orders by chunk): held finite only
    for g, w in zip(got[:-1], want[:-1]):
        assert float((g - w).abs().max()) <= 1e-2 * float(w.abs().max())

    jy, jg = jax.value_and_grad(
        lambda p, x: JS.ssd_forward(p, x, jcfg).sum(), argnums=(0, 1))(
            jl, jnp.asarray(x))
    assert np.isfinite(float(jy))
    assert abs(float(jy) - float(y.sum())) <= 1e-4 * float(y.abs().sum())
    assert np.isnan(np.asarray(jg[1])).any()
    assert np.isnan(np.asarray(jg[0]["dt_bias"])).any()
