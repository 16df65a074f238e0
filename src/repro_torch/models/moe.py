"""Mixture-of-Experts layer, in PyTorch: top-k routing with capacity, a
sorted dispatch into (E, cap, D) buffers, the experts as batched matmuls,
and a combine without atomics.

Counterpart of ``repro/models/moe.py``; the routing and the dropped
assignments are the reference's exactly:

  * the router runs in f32 (it must stay full f32 on the card, no TF32:
    the expert choice is discrete), softmax, then the top k by a stable
    descending sort, so a tie puts the lower expert first as
    ``lax.top_k`` does; the gates are renormalised;
  * assignments go to their experts in a stable sort by expert id, so an
    overfull expert drops its latest tokens; the capacity is the
    reference's, in Python integers;
  * each buffer row is gathered from its token (no scatter), and each
    token adds its k gated expert outputs one after another from zero in
    ascending expert order, in the activation dtype, as the reference's
    ``zeros.at[tok].add`` does in the sorted order.  No step adds with
    atomics, so a run on the card gives the same bits every time.
"""
from __future__ import annotations

from typing import Mapping, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from . import layers
from .config import ModelConfig


class Dispatch(NamedTuple):
    """The sorted assignment order of one batch of tokens: ``order`` (T*k,)
    the assignments (token * k + choice) by expert, stably; ``eid_s`` their
    experts; ``slot`` each one's place in its expert's buffer; ``keep``
    slot < cap; ``start`` and ``count`` (E,) each expert's first sorted
    assignment and how many it got (dropped ones included)."""
    order: torch.Tensor
    eid_s: torch.Tensor
    slot: torch.Tensor
    keep: torch.Tensor
    start: torch.Tensor
    count: torch.Tensor


def route(p: Mapping[str, torch.Tensor], xt: torch.Tensor, cfg: ModelConfig
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """xt: (T, D).  The router's softmax (T, E) f32, the top-k gates (T, k)
    f32 renormalised to sum 1 and their experts (T, k) int64, highest
    probability first, the lower expert first among equals."""
    logits = xt.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.moe_top_k
    top_p, top_i = top_p[:, :k], top_i[:, :k]
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)
    return probs, top_p, top_i


def capacity(T: int, cfg: ModelConfig) -> int:
    """Slots an expert takes from T tokens: ceil(T k / E) x the capacity
    factor, at most T, and at least min(8, T), which keeps a decode batch
    dropless."""
    E, k = cfg.moe_experts, cfg.moe_top_k
    cap = int(-(-T * k // E) * cfg.moe_capacity_factor)
    return max(min(8, T), min(cap, T))


def dispatch(top_i: torch.Tensor, cap: int, E: int) -> Dispatch:
    """The assignments of ``top_i`` (T, k) sorted stably by expert, each
    with its slot in its expert's buffer."""
    eid = top_i.reshape(-1)
    order = torch.argsort(eid, stable=True)
    eid_s = eid[order]
    experts = torch.arange(E, dtype=eid_s.dtype, device=eid_s.device)
    start = torch.searchsorted(eid_s, experts)
    count = torch.searchsorted(eid_s, experts, right=True) - start
    slot = torch.arange(eid.numel(), device=eid.device) - start[eid_s]
    return Dispatch(order, eid_s, slot, slot < cap, start, count)


def moe_block(p: Mapping[str, torch.Tensor], x: torch.Tensor,
              cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y in x's dtype, the Switch load-balance loss f32).
    ``p`` holds ``router`` (D, E) f32 and the experts' SwiGLU weights
    ``we_gate``, ``we_up`` (E, D, F) and ``we_down`` (E, F, D)."""
    B, S, D = x.shape
    E, k = cfg.moe_experts, cfg.moe_top_k
    T = B * S
    xt = layers.whole_seq(x).reshape(T, D)
    probs, top_p, top_i = route(p, xt, cfg)

    # the load-balance loss: E * sum_e f_e * p_e
    # (a compare against every expert, not ``bincount``: its output length
    # depends on the data, which a fake tensor cannot know)
    experts = torch.arange(E, device=x.device)
    counts = (top_i.reshape(-1, 1) == experts).sum(0).float()
    aux = E * ((counts / (T * k)) * probs.mean(0)).sum()

    # the dispatch: buffer row (e, c) holds the token of expert e's c-th
    # sorted assignment, or the zero row T where e got fewer than c + 1
    cap = capacity(T, cfg)
    # the sort and searches of the dispatch have no sharding rule: on a
    # mesh they run on the whole top_i, gathered onto every rank
    d = dispatch(layers.whole(top_i), cap, E)
    tok_s = d.order // k
    c = torch.arange(cap, device=x.device)
    src = (d.start[:, None] + c).clamp(max=T * k - 1)
    rows = torch.where(c < d.count[:, None], tok_s[src], T)
    # (on a mesh the tokens are gathered whole onto every rank for the
    # dispatch's gather, as the sort above)
    buf = layers.replicated(F.pad(layers.whole(xt), (0, 0, 0, 1))[rows],
                            like=xt)                          # (E, cap, D)

    # the experts (SwiGLU), one batched matmul each
    h = F.silu(torch.bmm(buf, p["we_gate"])) * torch.bmm(buf, p["we_up"])
    out = torch.bmm(h, p["we_down"]).reshape(E * cap, D)

    # the combine: each token's k sorted positions in ascending order (its
    # experts ascending), their gated outputs (0 for a dropped one), added
    # one after another from zero
    inv = torch.empty_like(d.order).scatter_(
        0, d.order, torch.arange(T * k, device=x.device))
    pos = torch.sort(inv.view(T, k), dim=-1).values          # (T, k)
    slot_c = torch.where(d.keep, d.slot, cap - 1)
    gate = torch.where(d.keep, top_p.reshape(-1)[d.order], 0.0).to(x.dtype)
    terms = out[(d.eid_s * cap + slot_c)[pos]] * gate[pos][..., None]
    y = torch.zeros((T, D), dtype=x.dtype, device=x.device)
    for j in range(k):
        y = y + terms[:, j]
    return y.reshape(B, S, D), aux
