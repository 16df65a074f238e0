"""AdamW with optional exact-quantile gradient clipping and quantile-scaled
int8 gradient compression, in PyTorch.

Counterpart of ``repro/optim/adamw.py``.  The state mirrors the parameter
tree (``m`` and ``v`` per leaf, f32), and the order of operations is the
reference's: compress, then the quantile clip, then the global-norm clip,
then warmup, bias correction and the decoupled weight decay.  Where the
reference's jitted step donates its buffers, ``adamw_update`` writes the
new parameters and moments into the given tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Tuple

import torch

from ..pytree import leaves, tree_map
from .quantile_ops import pytree_radix_quantile, quantile_clip_by_value


class AdamWState(NamedTuple):
    step: torch.Tensor       # 0-d int32
    m: Any
    v: Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    # the paper's primitive: clip |g| at its exact quantile
    quantile_clip: float = 0.0        # 0 disables; e.g. 0.999
    quantile_clip_eps: float = 1e-3
    grad_clip_norm: float = 1.0       # classic global-norm clip (0 disables)
    warmup_steps: int = 100
    # int8 gradient compression with an exact-quantile scale (0 disables)
    compress_bits: int = 0


def adamw_init(params) -> AdamWState:
    """Step 0 and f32 zero moments shaped as the parameter tree's leaves,
    on their devices."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    step = torch.zeros((), dtype=torch.int32,
                       device=leaves(params)[0].device)
    return AdamWState(step=step, m=tree_map(zeros, params),
                      v=tree_map(zeros, params))


def _global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(l.float().square().sum() for l in leaves(tree)))


def compress_int8(grads, *, q: float = 0.999, eps: float = 1e-3):
    """Quantile-scaled symmetric int8 quantization of the gradient tree:
    the scale is the exact q-quantile of |g| (radix route), so every
    replica derives the same codebook.  Returns (int8 tree, f32 scale)."""
    scale = pytree_radix_quantile(grads, q).to(torch.float32)
    scale = torch.clamp(scale, min=1e-12)

    def enc(g):
        gf = torch.clamp(g.float() / scale, -1.0, 1.0)
        return torch.round(gf * 127.0).to(torch.int8)

    return tree_map(enc, grads), scale


def decompress_int8(q8, scale):
    return tree_map(lambda g: g.float() * (scale / 127.0), q8)


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, cfg: AdamWConfig
                 ) -> Tuple[Any, AdamWState, dict]:
    """One optimizer step: (params, new state, metrics).  The new values
    are written into ``params``' leaves and ``state``'s moments, which come
    back as the new tree and state; ``grads`` is left as it is."""
    metrics = {}
    if cfg.compress_bits == 8:
        q8, scale = compress_int8(grads)
        grads = decompress_int8(q8, scale)
        metrics["compress_scale"] = scale
    if cfg.quantile_clip:
        grads, thr = quantile_clip_by_value(grads, cfg.quantile_clip,
                                            eps=cfg.quantile_clip_eps)
        metrics["clip_threshold"] = thr
    gnorm = _global_norm(grads)
    metrics["grad_norm"] = gnorm
    if cfg.grad_clip_norm:
        scale = torch.clamp(cfg.grad_clip_norm / torch.clamp(gnorm, min=1e-12),
                            max=1.0)
        grads = tree_map(lambda g: (g.float() * scale).to(g.dtype), grads)

    step = state.step + 1
    stepf = step.float()
    warm = torch.clamp(stepf / max(1, cfg.warmup_steps), max=1.0)
    lr = cfg.lr * warm
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                     device=stepf.device), stepf)
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                     device=stepf.device), stepf)

    def upd(p, g, m, v):
        gf = g.float()
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * gf)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * gf * gf)
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) \
            + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)

    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state.m),
                          leaves(state.v)):
        upd(p, g, m, v)
    return params, AdamWState(step=step, m=state.m, v=state.v), metrics
