"""The bf16 decode-vs-prefill gap of both packages, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/_decode_gap.py \
        [--batch 8] [--vocab 49152] 256 512 1024
    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/_decode_gap.py \
        --arch olmoe-1b-7b --layers 16 [64 256]

granite-8b's layer stack (36 layers, d_head 128, d_ff 3.5 d_model, one KV
head per four query heads) cut in width to each ``d_model`` given, with
bf16 weights from one JAX ``init_params``, carried to the port bit for bit.
For each package: the logits of ``decode_step`` after ``prefill(S)``
against ``prefill(S + 1)`` (the gap), and each of the two against an f32
evaluation of the same weights (JAX's ``prefill(S + 1)`` with the weights
cast to f32), each as max |diff| over max |logit|.  One JSON line a width.
``test_torch_models.py`` runs it at one small width.  With ``--arch``, the
same for that family's ``reduced()`` config at ``--layers`` and the widths
given (16 dims a head, d_ff 1.5 d_model; default the reduced width): the
moe family also counts the last position's expert choices that differ,
the vlm family runs with patch embeddings and an M-RoPE grid
(``family_gaps``).
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
    """granite-8b's layer stack cut to ``d_model``."""
    kw = dict(n_layers=36, d_model=d_model, n_heads=d_model // 128,
              n_kv_heads=max(1, d_model // 512), d_head=128,
              d_ff=7 * d_model // 2, vocab=vocab, attn_q_block=512,
              attn_kv_block=1024)
    kw.update(overrides)
    out = family_gaps("granite-8b", batch=batch, prompt=prompt, seed=seed,
                      reduced=False, **kw)
    out.update(d_model=d_model, vocab=vocab)
    return out


def family_gaps(arch: str, *, batch: int = 4, prompt: int = 64,
                seed: int = 0, reduced: bool = True, **overrides) -> dict:
    """The gaps of ``arch`` (its ``reduced()`` config unless ``reduced`` is
    False) with ``overrides``.  A vision_stub config gets N(0, 1) patch
    embeddings at its first ``frontend_len`` positions and an M-RoPE config
    the patches on a grid of width 4, (0, i // 4, i % 4), then text
    position j at (j, j, j).  A moe config also reports how many of the
    last position's expert choices differ between the decode and
    prefill(S + 1) and between bf16 and f32, over the layers
    (``routing``)."""
    import jax
    import jax.numpy as jnp
    import torch
    from repro.configs import get_config as jget_config
    from repro.models import model as JM
    from repro.models import moe as JMoE
    from repro_torch.configs import get_config
    from repro_torch.models import model as TM
    from repro_torch.models import moe as TMoE

    jcfg, cfg = jget_config(arch), get_config(arch)
    if reduced:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    kw = dict(attn_q_block=512, attn_kv_block=1024)
    kw.update(overrides)
    jcfg = dataclasses.replace(jcfg, **kw)
    cfg = dataclasses.replace(cfg, **kw)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    n, C = prompt, prompt + 8
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (batch, n + 1), dtype=np.int32)
    at = np.full((batch,), n, np.int32)
    extras = {}
    if cfg.modality == "vision_stub":
        extras["patch_embeds"] = rng.normal(
            size=(batch, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    p3 = None
    if cfg.mrope:
        i = np.arange(n + 1)
        p3 = np.stack([i, i, i]).astype(np.int32)
        F = cfg.frontend_len
        p3[:, :F] = np.stack([np.zeros(F, np.int32), i[:F] // 4, i[:F] % 4])
        p3 = np.broadcast_to(p3[:, None], (3, batch, n + 1)).copy()

    def inputs(m):
        b = {"tokens": toks[:, :m], **extras}
        if p3 is not None:
            b["positions3"] = p3[..., :m]
        return b

    # the experts each layer picks for the last position, by tapping the
    # reference's moe_block (the decode's input is its only position)
    picks = []
    if cfg.family == "moe":
        block = JMoE.moe_block

        def tap(p, x, c):
            xl = x[:, -1].astype(jnp.float32)
            probs = jax.nn.softmax(xl @ p["router"], axis=-1)
            jax.debug.callback(lambda t: picks.append(np.asarray(t)),
                               jax.lax.top_k(probs, c.moe_top_k)[1],
                               ordered=True)
            return block(p, x, c)
        JMoE.moe_block = tap

    def jax_run(c, p):
        picks.clear()
        prefill = jax.jit(lambda p, b: JM.prefill(p, b, c, cache_len=C))
        _, cache = prefill(p, inputs(n))
        picks.clear()
        step, _ = jax.jit(lambda p, t, k, a: JM.decode_step(p, t, k, a, c))(
            p, toks[:, n:], cache, at)
        jax.effects_barrier()
        step_picks = list(picks)
        picks.clear()
        full, _ = prefill(p, inputs(n + 1))
        jax.effects_barrier()
        return np.asarray(step), np.asarray(full), step_picks, list(picks)

    try:
        jstep, jfull, jsp, jfp = jax_run(jcfg, jp)
        _, ref, _, rfp = jax_run(
            dataclasses.replace(jcfg, param_dtype="float32"),
            jax.tree.map(lambda a: a.astype(jnp.float32), jp))
    finally:
        if cfg.family == "moe":
            JMoE.moe_block = block
    tp = TM.params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    del jp

    def t(a):
        return torch.from_numpy(np.array(a))

    tpicks = []
    if cfg.family == "moe":
        tblock = TMoE.moe_block

        def ttap(p, x, c):
            tpicks.append(TMoE.route(p, x[:, -1], c)[2].numpy())
            return tblock(p, x, c)
        TMoE.moe_block = ttap
    try:
        _, cache = TM.prefill(tp, {k: t(v) for k, v in inputs(n).items()},
                              cfg, cache_len=C)
        tpicks.clear()
        tstep, _ = TM.decode_step(tp, t(toks[:, n:]), cache, t(at), cfg)
        tsp = list(tpicks)
        tpicks.clear()
        tfull, _ = TM.prefill(tp, {k: t(v) for k, v in inputs(n + 1).items()},
                              cfg, cache_len=C)
        tfp = list(tpicks)
    finally:
        if cfg.family == "moe":
            TMoE.moe_block = tblock
    tstep, tfull = tstep.numpy(), tfull.numpy()

    def side(step, full, sp, fp):
        got = {"gap": _rel(step, full), "decode_vs_f32": _rel(step, ref),
               "prefill_vs_f32": _rel(full, ref)}
        if cfg.family == "moe":
            # each layer's picks are (B, k) at the last position
            same = [np.sort(a, -1) == np.sort(b, -1) for a, b in zip(sp, fp)]
            rows = np.all([s_.all(-1) for s_ in same], axis=0)
            got["routing_differs_decode_vs_prefill"] = int(
                sum((~s_.all(-1)).sum() for s_ in same))
            got["rows_same_routing"] = int(rows.sum())
            if rows.any():
                scale = np.abs(ref).max()
                got["same_rows_decode_vs_f32"] = float(
                    np.abs(step[rows] - ref[rows]).max() / scale)
                got["same_rows_prefill_vs_f32"] = float(
                    np.abs(full[rows] - ref[rows]).max() / scale)
        return got

    out = {"arch": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "batch": batch, "vocab": cfg.vocab,
           "prompt": prompt, "jax": side(jstep, jfull, jsp, jfp),
           "port": side(tstep, tfull, tsp, tfp)}
    if cfg.family == "moe":
        out["jax"]["routing_differs_bf16_vs_f32"] = int(sum(
            (np.sort(a, -1) != np.sort(b, -1)).any(-1).sum()
            for a, b in zip(jfp, rfp)))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("widths", type=int, nargs="*")
    ap.add_argument("--arch", default=None,
                    help="another family's reduced() config at the widths "
                         "given (default its own) and --layers")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--vocab", type=int, default=49152)
    ap.add_argument("--prompt", type=int, default=64)
    args = ap.parse_args()
    if args.arch:
        for d in args.widths or [None]:
            kw = {} if d is None else dict(d_model=d, n_heads=d // 16,
                                           d_ff=3 * d // 2)
            if args.layers:
                kw["n_layers"] = args.layers
            print(json.dumps(family_gaps(args.arch, batch=args.batch,
                                         prompt=args.prompt, seed=args.seed,
                                         **kw)),
                  flush=True)
        return
    for d in args.widths:
        print(json.dumps(gaps(d, batch=args.batch, vocab=args.vocab,
                              prompt=args.prompt)), flush=True)


if __name__ == "__main__":
    main()
