#!/usr/bin/env python3
"""Where decode and prefill part at full width, on one CUDA card.

    python3 scripts/decode_gap.py [--arch granite-8b] [--seed 0]
                                  [--batch 8] [--prompt 512]

Builds the arch's dense model with bf16 weights from ``--seed`` and the
prompts ``chip_smoke.py``'s ``serve_path`` serves (the same generator and
seed), then measures the decode-vs-prefill gap: the logits of
``decode_step`` after ``prefill(S)`` against ``prefill(S + 1)``, max |diff|
over max |logit|, in three settings of the same weights:

  * ``cublas_default``: PyTorch's default, which lets cuBLAS reduce the
    split-K partial sums of bf16 matmuls in bf16
    (``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``);
  * ``f32_sums``: that flag off, every bf16 matmul summing in f32, as the
    reference's bf16 dots do;
  * ``f32_sums_f32_decode_attention``: as ``f32_sums`` and the decode
    attention without the reference's bf16 casts of q, the cache and the
    probabilities.

For each setting it also prints the gap of each layer's output at the new
position (max |diff| over the prefill's max |x|), and the error of the
decode and of the prefill against the same weights evaluated in f32 (the
weights cast to f32, every activation f32; the decode attention's bf16
casts kept).  The last lines are the card's name and power limit and one
JSON object; the same object goes to ``chiprun_out/decode_gap.json``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import layers, model  # noqa: E402


@contextlib.contextmanager
def _reduced_bf16_sums(allowed: bool):
    flag = torch.backends.cuda.matmul
    before = flag.allow_bf16_reduced_precision_reduction
    flag.allow_bf16_reduced_precision_reduction = allowed
    try:
        yield
    finally:
        flag.allow_bf16_reduced_precision_reduction = before


@contextlib.contextmanager
def _f32_decode_attention():
    """The decode attention (Sq == 1) in f32 operands, the direct path's
    arithmetic, in place of the reference's bf16 casts."""
    attention = layers.attention

    def f32(q, k, v, pos_q, pos_k, *, causal=True, window=0, kv_len=None,
            **kw):
        if q.shape[1] != 1:
            return attention(q, k, v, pos_q, pos_k, causal=causal,
                             window=window, kv_len=kv_len, **kw)
        G = q.shape[2] // k.shape[2]
        k = k.repeat_interleave(G, dim=2).float()
        v = v.repeat_interleave(G, dim=2).float()
        s = torch.einsum("bqhd,bthd->bhqt", q.float() * q.shape[-1] ** -0.5,
                         k)
        s = s + layers._mask_bias(pos_q, pos_k, kv_len, causal,
                                  window)[:, None]
        o = torch.einsum("bhqt,bthd->bqhd", torch.softmax(s, -1), v)
        return o.to(q.dtype)

    layers.attention = f32
    try:
        yield
    finally:
        layers.attention = attention


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


@torch.no_grad()
def _hidden(params, tokens, cfg, S, cache_len):
    """prefill(S) then one decode step, and prefill(S + 1), by hand: the
    logits of both and each layer's output at position S."""
    B = tokens.shape[0]
    x, pos = model._embed_inputs(params, {"tokens": tokens[:, :S]})
    cache = model.init_cache(cfg, B, cache_len, device=params.device)
    for i, block in enumerate(params.blocks):
        x = block(x, positions=pos, cache=model._layer_cache(cache, i))
    at = torch.full((B,), S, dtype=torch.int32, device=params.device)
    x = params.p["embed"][tokens[:, S:].long()]
    step_h = []
    for i, block in enumerate(params.blocks):
        x = block(x, positions=at[:, None], cache=model._layer_cache(cache, i),
                  kv_len=at)
        step_h.append(x[:, 0])
    step = model._logits(params, x, cfg)
    x, pos = model._embed_inputs(params, {"tokens": tokens})
    cache = model.init_cache(cfg, B, cache_len, device=params.device)
    full_h = []
    for i, block in enumerate(params.blocks):
        x = block(x, positions=pos, cache=model._layer_cache(cache, i))
        full_h.append(x[:, -1])
    full = model._logits(params, x[:, -1:], cfg)
    return step, full, step_h, full_h


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=512)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("decode_gap: CUDA is not available", file=sys.stderr)
        return 2

    cfg = get_config(args.arch)
    B, S = args.batch, args.prompt
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 1)
    tokens = torch.randint(0, cfg.vocab, (B, S + 1), generator=gen,
                           device="cuda", dtype=torch.int32)
    params = model.init_params(cfg, args.seed, device="cuda")
    settings = {
        "cublas_default": (True, contextlib.nullcontext),
        "f32_sums": (False, contextlib.nullcontext),
        "f32_sums_f32_decode_attention": (False, _f32_decode_attention),
    }
    runs = {}
    for name, (allowed, ctx) in settings.items():
        with _reduced_bf16_sums(allowed), ctx():
            runs[name] = _hidden(params, tokens, cfg, S, S + 64)
    # the same weights in f32, every activation f32
    params.float()
    f32 = dataclasses.replace(cfg, param_dtype="float32")
    _, ref, _, _ = _hidden(params, tokens, f32, S, S + 64)
    out = {"arch": args.arch, "batch": B, "prompt": S, "seed": args.seed,
           "torch": torch.__version__, "cuda": torch.version.cuda}
    for name, (step, full, step_h, full_h) in runs.items():
        out[name] = {
            "gap": _rel(step, full),
            "decode_vs_f32": _rel(step, ref),
            "prefill_vs_f32": _rel(full, ref),
            "layer_gap": [_rel(a, b) for a, b in zip(step_h, full_h)],
        }
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "decode_gap.json"), "w") as f:
        json.dump({"card": smi, **out}, f, indent=1)
    print(smi)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
