"""The bf16 decode-vs-prefill gap of both packages, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/_decode_gap.py \
        [--batch 8] [--vocab 49152] 256 512 1024

granite-8b's layer stack (36 layers, d_head 128, d_ff 3.5 d_model, one KV
head per four query heads) cut in width to each ``d_model`` given, with
bf16 weights from one JAX ``init_params``, carried to the port bit for bit.
For each package: the logits of ``decode_step`` after ``prefill(S)``
against ``prefill(S + 1)`` (the gap), and each of the two against an f32
evaluation of the same weights (JAX's ``prefill(S + 1)`` with the weights
cast to f32), each as max |diff| over max |logit|.  One JSON line a width.
``test_torch_models.py`` runs it at one small width.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def gaps(d_model: int, *, batch: int = 4, vocab: int = 2048, prompt: int = 64,
         seed: int = 0, **overrides) -> dict:
    import jax
    import jax.numpy as jnp
    import torch
    from repro.configs import get_config as jget_config
    from repro.models import model as JM
    from repro_torch.configs import get_config
    from repro_torch.models import model as TM

    kw = dict(n_layers=36, d_model=d_model, n_heads=d_model // 128,
              n_kv_heads=max(1, d_model // 512), d_head=128,
              d_ff=7 * d_model // 2, vocab=vocab, attn_q_block=512,
              attn_kv_block=1024)
    kw.update(overrides)
    jcfg = dataclasses.replace(jget_config("granite-8b"), **kw)
    cfg = dataclasses.replace(get_config("granite-8b"), **kw)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    n, C = prompt, prompt + 8
    toks = np.random.default_rng(seed).integers(0, vocab, (batch, n + 1),
                                                dtype=np.int32)
    at = np.full((batch,), n, np.int32)

    def jax_run(c, p):
        prefill = jax.jit(lambda p, t: JM.prefill(p, {"tokens": t}, c,
                                                  cache_len=C))
        _, cache = prefill(p, toks[:, :n])
        step, _ = jax.jit(lambda p, t, k, a: JM.decode_step(p, t, k, a, c))(
            p, toks[:, n:], cache, at)
        full, _ = prefill(p, toks)
        return np.asarray(step), np.asarray(full)

    jstep, jfull = jax_run(jcfg, jp)
    _, ref = jax_run(dataclasses.replace(jcfg, param_dtype="float32"),
                     jax.tree.map(lambda a: a.astype(jnp.float32), jp))
    tp = TM.params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    del jp

    def t(a):
        return torch.from_numpy(np.array(a))

    _, cache = TM.prefill(tp, {"tokens": t(toks[:, :n])}, cfg, cache_len=C)
    tstep, _ = TM.decode_step(tp, t(toks[:, n:]), cache, t(at), cfg)
    tfull, _ = TM.prefill(tp, {"tokens": t(toks)}, cfg, cache_len=C)
    tstep, tfull = tstep.numpy(), tfull.numpy()
    return {"d_model": d_model, "batch": batch, "vocab": vocab,
            "prompt": prompt,
            "jax": {"gap": _rel(jstep, jfull),
                    "decode_vs_f32": _rel(jstep, ref),
                    "prefill_vs_f32": _rel(jfull, ref)},
            "port": {"gap": _rel(tstep, tfull),
                     "decode_vs_f32": _rel(tstep, ref),
                     "prefill_vs_f32": _rel(tfull, ref)}}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("widths", type=int, nargs="+")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--vocab", type=int, default=49152)
    ap.add_argument("--prompt", type=int, default=64)
    args = ap.parse_args()
    for d in args.widths:
        print(json.dumps(gaps(d, batch=args.batch, vocab=args.vocab,
                              prompt=args.prompt)), flush=True)


if __name__ == "__main__":
    main()
