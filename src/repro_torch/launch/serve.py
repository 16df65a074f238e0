"""Serving entry point of the port: batched prefill + decode with a KV cache,
and exact-quantile int8 activation calibration (the paper's primitive
applied to quantized serving).

Counterpart of ``repro/launch/serve.py``, for every model family.
Calibration comes in two shapes:

  * one-shot: ``calibrate_int8_scale`` / ``calibrate_int8_scales`` run a
    full GK Select job over a captured activation tensor;
  * streaming: pass a ``StreamingCalibrator`` to ``generate``: each step's
    logits fold into a persistent per-stream sketch, and scale queries run
    GK Select warm (no sketch sort per query).  ``--ingest-threads N`` (or
    ``REPRO_INGEST_THREADS``) hands observations to an ``IngestPool``
    instead of running an ingest tick inside the decode loop.

Usage:
  python -m repro_torch.launch.serve --arch granite-8b --calibrate
  python -m repro_torch.launch.serve --arch granite-8b --reduced \\
      --device cpu --prompt-len 32 --gen-len 16 --batch 4 --calibrate \\
      [--ingest-threads 4]
  python -m repro_torch.launch.serve --arch olmoe-1b-7b --reduced \\
      --device cpu --calibrate          # qwen2-vl-2b: zero patch embeds
  python -m repro_torch.launch.serve --arch mamba2-1.3b --reduced \\
      --device cpu --calibrate          # or zamba2-2.7b
  python -m repro_torch.launch.serve --arch seamless-m4t-large-v2 \\
      --reduced --device cpu            # zero frames, prompt_len // 4
"""
from __future__ import annotations

import argparse
import time
from typing import Mapping, Optional

import torch

from ..configs import get_config
from ..core import exact_quantile_rank, local_ops
from ..core.select import as_device_tensor, require_device
from ..models import model
from ..models.config import ModelConfig
from ..optim.quantile_ops import channelwise_exact_quantile
from .quantile_service import StreamingCalibrator


def calibrate_int8_scale(activations, q: float = 0.999,
                         num_partitions: int = 8,
                         device="cuda") -> torch.Tensor:
    """Exact q-quantile |activation| -> symmetric int8 scale, as a 0-d f32
    tensor.  Deterministic across runs and partition counts.

    The rank is taken on the TRUE element count and the partition pad is
    +inf: zero padding would inflate n and shift ceil(q*n).  Host data goes
    to ``device``; a tensor stays where it is."""
    flat = as_device_tensor(activations, device).to(torch.float32).abs()
    flat = flat.reshape(-1)
    k = local_ops.target_rank(flat.numel(), q)
    flat = local_ops.pad_with_high_sentinel(flat, num_partitions)
    return exact_quantile_rank(flat, k, num_partitions=num_partitions)


def calibrate_int8_scales(activations, axis: int = -1, q: float = 0.999,
                          num_partitions: int = 8,
                          device="cuda") -> torch.Tensor:
    """Per-CHANNEL symmetric int8 scales as one grouped GK Select job: the
    exact q-quantile of |activation| within each channel along ``axis``.
    Returns the (C,) scales."""
    x = as_device_tensor(activations, device).to(torch.float32).abs()
    return channelwise_exact_quantile(x, q, axis=axis,
                                      num_partitions=num_partitions)


@torch.no_grad()
def generate(cfg: ModelConfig, params: model.Transformer,
             prompts: torch.Tensor, *, gen_len: int,
             extras: Optional[Mapping[str, torch.Tensor]] = None,
             greedy: bool = True, seed: int = 0,
             calibrator: Optional[StreamingCalibrator] = None) -> torch.Tensor:
    """Batched prefill + autoregressive decode of ``gen_len`` tokens:
    (B, gen_len) int32 on the model's device.  ``extras`` join the
    prefill's batch (a vision_stub's ``patch_embeds``, ``positions3``, an
    encoder-decoder's ``frames``).

    ``calibrator`` observes the logits of the prefill and of every decode
    step through ``observe_many``: one ingest tick per step (a queue
    handoff when it has an ingest pool).  Greedy decoding takes the first
    maximal logit, as ``jnp.argmax``; sampling draws from a
    ``torch.Generator`` seeded with ``seed``, so its tokens are
    reproducible but not the JAX package's."""
    B, S = prompts.shape
    prompts = prompts.to(params.device)
    batch = {"tokens": prompts}
    for name, t in (extras or {}).items():
        batch[name] = t.to(params.device)
    logits, cache = model.prefill(params, batch, cfg, cache_len=S + gen_len)
    if calibrator is not None:
        calibrator.observe_many({"logits": logits})
    gen = torch.Generator(device=params.device).manual_seed(int(seed))
    out = []
    tok = logits.argmax(-1)[:, None].to(torch.int32)
    out.append(tok)
    for i in range(gen_len - 1):
        cache_len = torch.full((B,), S + i, dtype=torch.int32,
                               device=params.device)
        logits, cache = model.decode_step(params, tok, cache, cache_len, cfg)
        if calibrator is not None:
            calibrator.observe_many({"logits": logits})
        if greedy:
            tok = logits.argmax(-1)[:, None].to(torch.int32)
        else:
            tok = torch.multinomial(torch.softmax(logits, -1), 1,
                                    generator=gen).to(torch.int32)
        out.append(tok)
    return torch.cat(out, dim=1)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--calibrate", action="store_true",
                    help="maintain a running logits sketch across decode "
                         "steps and report the exact (warm) int8 scale")
    ap.add_argument("--ingest-threads", type=int, default=None,
                    help="threaded calibration ingest: worker count for the "
                         "IngestPool (default: REPRO_INGEST_THREADS env var, "
                         "else 0 = synchronous)")
    ap.add_argument("--device", default="cuda",
                    help="where the model and the calibration run "
                         "(default cuda; cpu runs the plain versions)")
    args = ap.parse_args(argv)

    device = require_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = model.init_params(cfg, 0, device=device)
    gen = torch.Generator(device=device).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                            generator=gen, device=device, dtype=torch.int32)
    extras = {}
    if cfg.modality == "vision_stub":
        extras["patch_embeds"] = torch.zeros(
            (args.batch, cfg.frontend_len, cfg.d_model), device=device)
    if cfg.is_encdec:
        extras["frames"] = torch.zeros(
            (args.batch, max(1, args.prompt_len // cfg.enc_seq_divisor),
             cfg.d_model), device=device)
    calibrator = (StreamingCalibrator(q=0.999, device=device,
                                      ingest_threads=args.ingest_threads)
                  if args.calibrate else None)
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = generate(cfg, params, prompts, gen_len=args.gen_len,
                    extras=extras, calibrator=calibrator)
    if device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f"generated {tuple(toks.shape)} in {dt:.2f}s "
          f"({args.batch * args.gen_len / dt:.1f} tok/s)")
    print(toks[:2, :8].cpu().numpy())
    if calibrator is not None:
        mode = (f"threaded x{calibrator.pool.workers}"
                if calibrator.pool is not None else "synchronous")
        print(f"streaming calibration ({mode}): "
              f"{calibrator.observed('logits')} "
              f"|logit| samples, exact p99.9 scale (warm) = "
              f"{float(calibrator.scale('logits')):.6f} "
              f"(approx O(s) = {float(calibrator.approx_scale('logits')):.6f})")
        calibrator.close()


if __name__ == "__main__":
    main()
