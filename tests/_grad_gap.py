"""The bf16 gradient's gap to an f32 evaluation, in both packages, on the
CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/_grad_gap.py \
        --arch seamless-m4t-large-v2 --layers 24 [--seq 256] [--steps 3] \
        128 256

A family's ``reduced()`` config at ``--layers`` (an encoder-decoder's
encoder too) and each ``d_model`` given (64 dims an attention or SSD head,
an M-RoPE head its published 128; d_ff 4 d_model, an expert's d_model /
2; the published vocabulary, attention blocks, M-RoPE sections, SSD
state and chunk, experts and top-k), with bf16 weights from one JAX
``init_params``, after ``--steps`` steps of JAX's ``train_loop``,
carried to the port bit for bit, and the pipeline's next batch of
``--batch`` x ``--seq`` Zipf tokens (with its patches or frames).  For
each package: every gradient of ``forward_loss`` in bf16 against the
same weights cast to f32 (``param_dtype="float32"``), max |g_bf16 -
g_f32| over max |g_f32| of each leaf of the port's tree (a layer at a
time, as ``chip_smoke.py``'s train phases gate it at full width): the
worst leaf, the count past ``--tol``, the worst layer of each leaf of the
reference's layout (``per_stacked_leaf``) and that leaf taken whole
(``stacked``).  One JSON line a width.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np


def _summary(tree, got, want, tol: float) -> dict:
    """Each leaf's max |g - w| over max |w| (the leaves of ``tree``, the
    port's ``param_tree``: a layer at a time), the worst leaf and the
    count past ``tol``; grouped by the leaf of the reference's layout
    that stacks them (``model.by_stacked_leaf``), each group's worst layer
    (``per_stacked_leaf``) and the group taken whole, max |g - w| of its
    layers over max |w| of its layers (``stacked``)."""
    from repro_torch import pytree
    from repro_torch.models import model as TM

    diff = [float(np.abs(np.asarray(g, np.float64) - w).max())
            for g, w in zip(got, want)]
    scale = [float(np.abs(np.asarray(w, np.float64)).max()) for w in want]
    gap = [d / max(w, 1e-30) for d, w in zip(diff, scale)]
    paths = pytree.paths(tree)
    worst = int(np.argmax(gap))

    def ranked(kv: dict) -> dict:
        return dict(sorted(kv.items(), key=lambda kv: -kv[1]))

    d, w, g = (TM.by_stacked_leaf(tree, v) for v in (diff, scale, gap))
    return {"worst_leaf": paths[worst], "worst": gap[worst],
            "over_tol": sum(x > tol for x in gap),
            "per_stacked_leaf": ranked({k: max(v) for k, v in g.items()}),
            "stacked": ranked({k: max(d[k]) / max(max(w[k]), 1e-30)
                               for k in d})}


def grad_gaps(arch: str, d_model: int, *, layers: int, batch: int = 2,
              seq: int = 256, steps: int = 0, tol: float = 3e-2,
              seed: int = 0) -> dict:
    import jax
    import jax.numpy as jnp
    import torch
    from repro.configs import get_config as jget_config
    from repro.launch.train import train_loop as jtrain_loop
    from repro.models import model as JM
    from repro_torch import pytree
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticPipeline
    from repro_torch.models import model as TM

    full = get_config(arch)
    kw = dict(n_layers=layers, d_model=d_model, vocab=full.vocab,
              attn_q_block=full.attn_q_block,
              attn_kv_block=full.attn_kv_block)
    if full.n_heads:
        # M-RoPE's sections cover the published head's rotary half
        dh = full.d_head if full.mrope else 64
        kw.update(n_heads=max(1, d_model // dh), d_head=dh,
                  d_ff=4 * d_model, mrope_sections=full.mrope_sections,
                  n_kv_heads=max(1, d_model // dh * full.n_kv_heads
                                 // full.n_heads))
    if full.enc_layers:
        kw["enc_layers"] = layers
    if full.ssm_state:
        kw.update(ssm_state=full.ssm_state, ssm_head_dim=64,
                  ssm_chunk=full.ssm_chunk)
    if full.moe_experts:
        kw.update(moe_experts=full.moe_experts, moe_top_k=full.moe_top_k,
                  d_ff=d_model // 2)
    jcfg = dataclasses.replace(jget_config(arch).reduced(), **kw)
    cfg = dataclasses.replace(get_config(arch).reduced(), **kw)
    pipe = SyntheticPipeline(DataConfig(
        vocab=cfg.vocab, seq_len=seq, global_batch=batch, seed=seed,
        frontend_len=cfg.frontend_len,
        enc_seq=seq // cfg.enc_seq_divisor if cfg.is_encdec else 0,
        d_model=cfg.d_model))
    data = pipe.batch_at(steps)

    losses = []
    if steps:
        run = jtrain_loop(jcfg, steps=steps, global_batch=batch, seq_len=seq,
                          seed=seed, log_every=0)
        jp, losses = run["params"], run["losses"]
    else:
        jp = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    jgrad = jax.jit(jax.grad(lambda p, b, c: JM.forward_loss(p, b, c)[0]),
                    static_argnums=2)
    jb = {k: jnp.asarray(v) for k, v in data.items()}
    j16 = jax.tree.leaves(jgrad(jp, jb, jcfg))
    j32 = jax.tree.leaves(jgrad(jax.tree.map(lambda a: a.astype(jnp.float32),
                                             jp), jb,
                                dataclasses.replace(jcfg,
                                                    param_dtype="float32")))
    tp = TM.params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    del jp
    tree = TM.param_tree(tp)
    layout = TM.params_to_numpy(tp)

    def per_layer(stacked_leaves):
        """The reference's gradients as the port's tree holds them."""
        out = TM.unstacked(pytree.unflatten(
            layout, [torch.from_numpy(np.asarray(a, np.float32))
                     for a in stacked_leaves]))
        assert pytree.paths(out) == pytree.paths(tree)
        return [t.numpy() for t in pytree.leaves(out)]

    def port(params, c):
        params.requires_grad_(True)
        loss, _ = TM.forward_loss(params, {k: torch.from_numpy(np.array(v))
                                           for k, v in data.items()}, c)
        loss.backward()
        return [w.grad.float().numpy()
                for w in pytree.leaves(TM.param_tree(params))]

    t16 = port(tp, cfg)
    c32 = dataclasses.replace(cfg, param_dtype="float32")
    tp32 = TM.Transformer(c32, device="cpu")
    with torch.no_grad():
        for dst, src in zip(pytree.leaves(TM.param_tree(tp32)),
                            pytree.leaves(tree)):
            dst.copy_(src)
    t32 = port(tp32, c32)

    def f32(a):
        return np.asarray(jnp.asarray(a, jnp.float32))

    j16 = per_layer([f32(a) for a in j16])
    j32 = per_layer([f32(a) for a in j32])
    return {"arch": arch, "d_model": d_model, "layers": layers,
            "batch": batch, "seq": seq, "steps": steps, "vocab": cfg.vocab,
            "losses": losses, "tol": tol,
            "jax": _summary(tree, j16, j32, tol),
            "port": _summary(tree, t16, t32, tol)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--layers", type=int, required=True)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--tol", type=float, default=3e-2)
    ap.add_argument("widths", nargs="+", type=int)
    args = ap.parse_args()
    for d in args.widths:
        print(json.dumps(grad_gaps(args.arch, d, layers=args.layers,
                                   batch=args.batch, seq=args.seq,
                                   steps=args.steps, tol=args.tol)),
              flush=True)


if __name__ == "__main__":
    main()
