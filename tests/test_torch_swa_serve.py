"""Serving a sliding-window model through its ring cache: reduced
h2o-danube-1.8b (window 32) with f32 weights from JAX's ``init_params``,
carried over by ``params_from_numpy``, against the JAX package's jitted
``generate``, ``prefill`` and ``decode_step``.

- greedy ``generate`` of 16 tokens after a prompt of 24: cache_len 40
  makes a ring of 32 slots, and positions 32..38 overwrite the oldest;
  the tokens are JAX's;
- decode past the wrap: teacher-forced steps over positions 24..36 after
  ``prefill(24)``, the step at 36 against JAX's and against the blocks run
  with no cache, where every query sees its own window (the decode
  tolerance of ``test_torch_models.py``, 1e-3 of max |logit|); and
  ``prefill(37)``, JAX's within 1e-5, is not that: its queries before the
  last window lose their first keys (``ROADMAP.md`` Queue 3 item 7), so
  its last logits differ although its last query sees the ring's
  positions;
- sampled ``generate``: draws from a seeded ``torch.Generator``, so the
  same tokens twice under one seed, each in [0, vocab), and other tokens
  under another seed.  They are not JAX's tokens: the generators differ;
- the serve CLI on the reduced config, whose warm int8 scale is the sort
  oracle's bit for bit."""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402
from repro.configs import get_config as jget_config           # noqa: E402
from repro.launch import serve as JS                          # noqa: E402
from repro.models import model as JM                          # noqa: E402
from repro_torch.configs import get_config                    # noqa: E402
from repro_torch.launch import StreamingCalibrator            # noqa: E402
from repro_torch.launch import serve as TS                    # noqa: E402
from repro_torch.models import model as TM                    # noqa: E402

ARCH = "h2o-danube-1.8b"
B, PROMPT, GEN = 2, 24, 16
DECODE_TOL = 1e-3


def _rel(got, want):
    want = np.asarray(want, np.float32)
    err = np.abs(np.asarray(got, np.float32) - want).max()
    return err / max(np.abs(want).max(), 1e-30)


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jget_config(ARCH).reduced(),
                               param_dtype="float32")
    cfg = dataclasses.replace(get_config(ARCH).reduced(),
                              param_dtype="float32")
    jp = JM.init_params(jcfg, jax.random.PRNGKey(11))
    tp = TM.params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                              device="cpu")
    toks = np.random.default_rng(12).integers(0, cfg.vocab, (B, PROMPT + 16),
                                              dtype=np.int32)
    return jcfg, jp, cfg, tp, toks


def test_greedy_generate_through_the_ring_gives_jax_tokens(models):
    jcfg, jp, cfg, tp, toks = models
    assert cfg.swa_window == 32 < PROMPT + GEN
    prompts = toks[:, :PROMPT]
    want = np.asarray(JS.generate(jcfg, jp, jax.numpy.asarray(prompts),
                                  gen_len=GEN))
    got = TS.generate(cfg, tp, torch.from_numpy(prompts), gen_len=GEN)
    assert got.dtype == torch.int32 and got.shape == (B, GEN)
    assert got.numpy().tolist() == want.tolist()


def test_decode_past_the_wrap_sees_the_true_window(models):
    jcfg, jp, cfg, tp, toks = models
    at = 36
    cache_len = PROMPT + GEN
    _, cache = TM.prefill(tp, {"tokens": torch.from_numpy(toks[:, :PROMPT])},
                          cfg, cache_len=cache_len)
    assert cache["k"].shape[2] == cfg.swa_window
    jl, jc = jax.jit(lambda p, t: JM.prefill(p, {"tokens": t}, jcfg,
                                             cache_len=cache_len))(
        jp, toks[:, :PROMPT])
    decode = jax.jit(lambda p, t, c, n: JM.decode_step(p, t, c, n, jcfg))
    for p in range(PROMPT, at + 1):
        n = np.full((B,), p, np.int32)
        step, cache = TM.decode_step(tp, torch.from_numpy(toks[:, p:p + 1]),
                                     cache, torch.from_numpy(n), cfg)
        jl, jc = decode(jp, toks[:, p:p + 1], jc, n)
    # slots 0..4 took positions 32..36; slots 5..31 keep 5..31
    assert cache["pos"][0, 0].tolist() == (list(range(32, at + 1))
                                           + list(range(at - 31, 32)))
    assert _rel(step.numpy(), jl) <= DECODE_TOL
    # the same blocks with no cache: every query attends over its own
    # window, as each decode step did
    tokens = torch.from_numpy(toks[:, :at + 1])
    x, positions, _ = TM._embed_inputs(tp.p, {"tokens": tokens}, cfg)
    for block in tp.blocks:
        x, _ = block(x, positions=positions)
    windowed = TM._logits(tp, x[:, -1:], cfg)
    assert _rel(step.numpy(), windowed.numpy()) <= DECODE_TOL
    # prefill(37) writes positions 5..36 into the ring, and its queries
    # before the last window lose their first keys (the reference's quirk):
    # the last query's keys are the ring's positions, but not their values
    full, fcache = TM.prefill(tp, {"tokens": tokens}, cfg,
                              cache_len=cache_len)
    assert sorted(fcache["pos"][0, 0].tolist()) == list(range(at - 31,
                                                              at + 1))
    jfull, _ = jax.jit(lambda p, t: JM.prefill(p, {"tokens": t}, jcfg,
                                               cache_len=cache_len))(
        jp, toks[:, :at + 1])
    assert _rel(full.numpy(), jfull) <= 1e-5
    assert _rel(full.numpy(), windowed.numpy()) > DECODE_TOL


def test_sampled_generate_is_reproducible_and_in_range(models):
    _, _, cfg, tp, toks = models
    prompts = torch.from_numpy(toks[:, :PROMPT])
    a = TS.generate(cfg, tp, prompts, gen_len=GEN, greedy=False, seed=5)
    b = TS.generate(cfg, tp, prompts, gen_len=GEN, greedy=False, seed=5)
    c = TS.generate(cfg, tp, prompts, gen_len=GEN, greedy=False, seed=6)
    assert a.dtype == torch.int32 and a.shape == (B, GEN)
    assert torch.equal(a, b)
    assert int(a.min()) >= 0 and int(a.max()) < cfg.vocab
    # the first token is the prefill's argmax under every seed; the draws
    # after it follow the seed
    assert torch.equal(a[:, 0], c[:, 0]) and not torch.equal(a, c)


def test_serve_cli_scale_is_the_sort_oracles(monkeypatch, capsys):
    made = []

    class Tap(StreamingCalibrator):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.seen, self.scales = [], []
            made.append(self)

        def observe_many(self, named):
            self.seen.append(named["logits"].clone())
            super().observe_many(named)

        def scale(self, name):
            out = super().scale(name)
            self.scales.append(out.clone())
            return out

    monkeypatch.setattr(TS, "StreamingCalibrator", Tap)
    TS.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--prompt-len",
             str(PROMPT), "--gen-len", str(GEN), "--calibrate"])
    out = capsys.readouterr().out
    assert "generated (4, 16)" in out and "exact p99.9 scale (warm)" in out
    (cal,) = made
    assert len(cal.seen) == GEN and len(cal.scales) == 1
    observed = torch.cat([t.reshape(-1) for t in cal.seen]).abs()
    assert observed.numel() == 4 * GEN * get_config(ARCH).reduced().vocab
    k = math.ceil(0.999 * observed.numel())
    want = torch.sort(observed).values[k - 1]
    assert cal.scales[0].view(torch.int32).item() == \
        want.view(torch.int32).item()
