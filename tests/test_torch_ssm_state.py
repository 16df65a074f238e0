"""The port's chunked SSD scan against its own recurrence, the short-prompt
behaviour of the reference, and the mamba weights crossing both packages
(models, helpers and tolerances: ``test_torch_ssm.py``)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402
from repro.models import model as JM                          # noqa: E402
from repro_torch.configs import get_config                    # noqa: E402
from repro_torch.models import model as TM                    # noqa: E402
from repro_torch.models import ssm as TS                      # noqa: E402

from test_torch_ssm import (ARCHS, B, DTYPES, TOL, _bits, _np, _rel,
    _shared_models, _t, _x)


@pytest.mark.parametrize("L", [16, 19])
@pytest.mark.parametrize("dtype", DTYPES)
def test_chunked_scan_matches_its_sequential_oracle(dtype, L):
    cfg = dataclasses.replace(get_config("mamba2-1.3b").reduced(),
                              param_dtype=dtype)
    p = TM.init_params(cfg, 2, device="cpu").blocks[1].p
    x = _t(_x(L, cfg.d_model, seed=3)).to(getattr(torch, dtype))
    y1 = _np(TS.ssd_forward(p, x, cfg))
    y2 = _np(TS.ssd_reference(p, x, cfg))
    assert np.abs(y1 - y2).max() / max(np.abs(y2).max(), 1e-6) < 1e-2


@pytest.mark.parametrize("S_prompt", [1, 2, 3])
def test_short_prompt_breaks_decode_as_the_reference(S_prompt):
    """A prompt shorter than ``ssm_conv - 1 = 3`` tokens leaves a conv
    state of one row in both packages, and the next decode step raises in
    both (``ROADMAP.md`` Queue 3 item 6); at 3 tokens decode works and
    matches."""
    jcfg, jp, tp = _shared_models("mamba2-1.3b", "float32")
    toks = np.random.default_rng(6).integers(0, jcfg.vocab, (B, S_prompt + 1),
                                             dtype=np.int32)
    jl, jc = JM.prefill(jp, {"tokens": toks[:, :S_prompt]}, jcfg)
    tl, tc = TM.prefill(tp, {"tokens": _t(toks[:, :S_prompt])}, tp.cfg)
    rows = min(S_prompt, 1) if S_prompt < 3 else 3
    assert jc["conv"].shape[2] == tc["conv"].shape[2] == rows
    n = np.full((B,), S_prompt, np.int32)
    tok = toks[:, S_prompt:]
    if S_prompt < 3:
        with pytest.raises(ValueError):
            JM.decode_step(jp, tok, jc, n, jcfg)
        with pytest.raises(ValueError, match="shorter than"):
            TM.decode_step(tp, _t(tok), tc, _t(n), tp.cfg)
    else:
        jl, _ = JM.decode_step(jp, tok, jc, n, jcfg)
        tl, _ = TM.decode_step(tp, _t(tok), tc, _t(n), tp.cfg)
        assert _rel(tl.numpy(), jl) <= TOL["float32"]


@pytest.mark.parametrize("arch", ARCHS)
def test_params_cross_both_ways_bit_for_bit(arch):
    """JAX's weights into the port and back, in the reference's layout
    (``blocks`` of (L, ...) leaves; ``mamba`` of (G, every, ...) and one
    ``shared`` block), bit for bit; a tree of the wrong depth raises."""
    jcfg, jp, tp = _shared_models(arch, "bfloat16")
    back = TM.params_to_numpy(tp)
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        assert got.shape == want.shape
        np.testing.assert_array_equal(_bits(got), _bits(want))
    if arch == "mamba2-1.3b":                 # one layer of two
        cut = dict(back, blocks={k: v[:1] for k, v in back["blocks"].items()})
    else:                                     # one layer a group of two
        cut = dict(back, mamba={k: v[:, :1] for k, v in back["mamba"].items()})
    with pytest.raises(ValueError):
        TM.params_from_numpy(tp.cfg, cut, device="cpu")
