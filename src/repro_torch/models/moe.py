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
    ``zeros.at[tok].add`` does in the sorted order.  No step of the
    forward adds with atomics, so a forward on the card gives the same
    bits every time.  The backward makes no such promise: each gather's
    backward is an accumulating ``index_put_``, which adds a token's k
    buffer rows into its gradient row in the activation dtype.

On a mesh (``x`` a DTensor) the layer is expert-parallel, as the
reference's placement makes it: the (E, cap, ·) buffers, the expert
products and their outputs are split over the experts where the expert
weights are (``"model"``) and over the capacity on every other mesh
dimension (the batch axes), so no rank holds one whole.  The routing and
the global slots are the plain layer's: the dispatch's sort runs on the
whole ``top_i``, gathered onto every rank.  The token rows reach the ranks
that own their slots through all-gathers of windows of the tokens (one
window a rank of the batch axes), and the expert outputs come back
through all-gathers of windows of the capacity; each rank then picks its
rows by index, so the peak holds one window and the local buffers.  Every
shape is static, fake tensors included.  The combine adds each token's k
terms in the plain order: each expert rank fills the terms of its own
experts and zeros elsewhere, and the sum over the expert axis (the
reduce-scatter to the residual stream's placement) adds one term to
zeros, so the forward's bits do not depend on the mesh.
"""
from __future__ import annotations

from typing import Mapping, NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..dtensor import from_shards, shard_range
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


def _balance_loss(probs: torch.Tensor, top_i: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    """The Switch load-balance loss, E * sum_e f_e * p_e (a compare
    against every expert, not ``bincount``: its output length depends on
    the data, which a fake tensor cannot know)."""
    E = cfg.moe_experts
    experts = torch.arange(E, device=top_i.device)
    counts = (top_i.reshape(-1, 1) == experts).sum(0).float()
    return E * ((counts / top_i.numel()) * probs.mean(0)).sum()


def _experts(p: Mapping[str, torch.Tensor], buf: torch.Tensor
             ) -> torch.Tensor:
    """The experts (SwiGLU) on their (E, cap, D) buffer, one batched
    matmul each: the (E, cap, D) outputs."""
    h = F.silu(torch.bmm(buf, p["we_gate"])) * torch.bmm(buf, p["we_up"])
    return torch.bmm(h, p["we_down"])


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
    ``we_gate``, ``we_up`` (E, D, F) and ``we_down`` (E, F, D).  On a
    mesh, expert-parallel (the module's docstring)."""
    if isinstance(x, DTensor):
        return _moe_block_on_mesh(p, x, cfg)
    B, S, D = x.shape
    E, k = cfg.moe_experts, cfg.moe_top_k
    T = B * S
    xt = x.reshape(T, D)
    probs, top_p, top_i = route(p, xt, cfg)
    aux = _balance_loss(probs, top_i, cfg)

    # the dispatch: buffer row (e, c) holds the token of expert e's c-th
    # sorted assignment, or the zero row T where e got fewer than c + 1
    cap = capacity(T, cfg)
    d = dispatch(top_i, cap, E)
    tok_s = d.order // k
    c = torch.arange(cap, device=x.device)
    src = (d.start[:, None] + c).clamp(max=T * k - 1)
    rows = torch.where(c < d.count[:, None], tok_s[src], T)
    buf = F.pad(xt, (0, 0, 0, 1))[rows]                      # (E, cap, D)

    out = _experts(p, buf).reshape(E * cap, D)

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


# ---------------------------------------------------------------------------
# on a mesh: expert-parallel
# ---------------------------------------------------------------------------


def _linear(mesh, dims) -> Tuple[int, int]:
    """(this rank's row-major index over mesh ``dims``, their product):
    its place among the pieces that a dimension sharded over ``dims`` (in
    mesh order) splits into."""
    coord = mesh.get_coordinate()
    idx, n = 0, 1
    for i in dims:
        idx, n = idx * mesh.size(i) + coord[i], n * mesh.size(i)
    return idx, n


def _gathered(piece: torch.Tensor, mesh, place, shape, to,
              sums) -> torch.Tensor:
    """The DTensor of global ``shape`` whose shard here is ``piece``, under
    ``place``, redistributed to ``to``, as this rank's local tensor.  Its
    gradient is a partial sum on the mesh dimensions ``sums`` (the ranks
    there read different rows of what they gathered), which the backward
    reduces onto ``place``, and placed as ``to`` on the others (the ranks
    there read the same rows, so their gradients are one and the same)."""
    grad_place = [Partial() if i in sums else q for i, q in enumerate(to)]
    return from_shards(piece, mesh, place, shape).redistribute(
        mesh, to).to_local(grad_placements=grad_place)


def _moe_block_on_mesh(p: Mapping[str, torch.Tensor], x: torch.Tensor,
                       cfg: ModelConfig
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``moe_block`` of a DTensor ``x``, expert-parallel: the buffers
    (E, cap, ·) split over the experts on the mesh dimensions that split
    ``we_gate``'s experts and over the capacity on the others."""
    B, S, D = x.shape
    E, k = cfg.moe_experts, cfg.moe_top_k
    T = B * S
    mesh = x.device_mesh
    nd = mesh.ndim
    w = p["we_gate"]
    ep = [i for i, q in enumerate(w.placements) if q.is_shard()
          and q.dim == 0]
    cd = [i for i in range(nd) if i not in ep]

    # the tokens, whole in the sequence and the features, split over the
    # batch on the mesh dimensions that split it (whole on the expert
    # dimensions)
    bd = [i for i, q in enumerate(x.placements) if q.is_shard()
          and q.dim == 0 and i not in ep]
    place_x = [Shard(0) if i in bd else Replicate() for i in range(nd)]
    xt = x.redistribute(mesh, place_x).reshape(T, D)
    probs, top_p, top_i = route(p, xt, cfg)
    aux = _balance_loss(probs, top_i, cfg)

    # the global dispatch, as the plain layer's, on the whole top_i
    cap = capacity(T, cfg)
    d = dispatch(layers.whole(top_i), cap, E)
    dev = x.device
    b, nb = _linear(mesh, bd)
    tn = T // nb                              # this rank's tokens
    t0 = b * tn
    e0, en = shard_range(E, mesh, w.placements, 0)
    r, ncap = _linear(mesh, cd)
    c = -(-cap // ncap)                       # slots a rank (the last pad)
    place_buf = [Shard(0) if i in ep else Shard(1) for i in range(nd)]

    # dispatch: this rank's slots (en, c), each the global token of its
    # sorted assignment (-1: none), picked out of all-gathered windows of
    # the tokens (nw windows of wt tokens from each batch rank)
    slot = r * c + torch.arange(c, device=dev)
    es = torch.arange(e0, e0 + en, device=dev)
    src = (d.start[es, None] + slot).clamp(max=T * k - 1)
    tok = torch.where((slot < d.count[es, None]) & (slot < cap),
                      d.order[src] // k, -1)
    nw = min(nb, tn)
    wt = -(-tn // nw)
    x_loc = F.pad(xt.to_local(), (0, 0, 0, nw * wt - tn))
    off = tok % tn
    at = (tok // tn) * wt + off % wt          # the token's row in its window
    buf = torch.zeros((en, c, D), dtype=x.dtype, device=dev)
    for i in range(nw):
        win = F.pad(_gathered(x_loc[i * wt:(i + 1) * wt], mesh, place_x,
                              (nb * wt, D), [Replicate()] * nd, range(nd)),
                    (0, 0, 0, 1))
        sel = (tok >= 0) & (off // wt == i)
        buf = torch.where(sel[..., None], win[torch.where(sel, at, nb * wt)],
                          buf)
    # the expert weights gathered on the capacity's dimensions (FSDP), so
    # that the products keep the buffer's split, where the capacity
    # outweighs an expert's width (a train or prefill step); a decode
    # step's few slots are left to DTensor, which moves them, not the
    # weights
    place_ep = [Shard(0) if i in ep else Replicate() for i in range(nd)]
    pw = p
    if cap > cfg.d_ff:
        pw = {n: p[n].redistribute(mesh, place_ep)
              for n in ("we_gate", "we_up", "we_down")}
    out = _experts(pw, from_shards(buf, mesh, place_buf, (E, ncap * c, D)))
    out = out.redistribute(mesh, place_buf).to_local()      # (en, c, D)

    # combine: the terms of this rank's tokens (tn, k) in ascending expert
    # order, for the assignments to its experts, each written from the
    # all-gathered window of the capacity that holds its slot (the ranks
    # of a capacity dimension outside the batch's, which split no tokens,
    # make the same terms: the window's gradient sums over ``bd`` alone)
    inv = torch.empty_like(d.order).scatter_(
        0, d.order, torch.arange(T * k, device=dev))
    pos = torch.sort(inv.view(T, k)[t0:t0 + tn], dim=-1).values
    eid, slot = d.eid_s[pos], d.slot[pos]
    mine = d.keep[pos] & (eid >= e0) & (eid < e0 + en)
    # (windows of at most the rows of this rank's terms, tn * k)
    nw = max(1, min(ncap, c, -(-en * ncap * c // (tn * k))))
    wc = -(-c // nw)
    out = F.pad(out, (0, 0, 0, nw * wc - c))
    off = slot % c
    at = ((eid - e0) * ncap + slot // c) * wc + off % wc
    dump = tn * k                             # the row of the others' terms
    rows = torch.arange(tn * k, device=dev).view(tn, k)
    terms = torch.zeros((tn * k + 1, D), dtype=x.dtype, device=dev)
    for i in range(nw):
        win = _gathered(out[:, i * wc:(i + 1) * wc], mesh, place_buf,
                        (E, ncap * wc, D), place_ep, bd).reshape(-1, D)
        sel = mine & (off // wc == i)
        # each window row to the term it serves (the others to ``dump``;
        # a slot serves one assignment, so no row is written twice)
        n = win.shape[0]
        dst = torch.full((n + 1,), dump, device=dev).scatter_(
            0, torch.where(sel, at, n).view(-1),
            torch.where(sel, rows, dump).view(-1))
        terms.index_put_((dst[:n],), win)
    gate = top_p.redistribute(mesh, place_x).to_local(grad_placements=[
        Partial() if i in ep else q for i, q in enumerate(place_x)])
    gate = torch.where(mine, gate.reshape(-1)[d.order[pos] - t0 * k], 0.0)
    terms = terms[:dump].view(tn, k, D) * gate.to(x.dtype)[..., None]

    # the sum over the expert dimensions (one term, zeros elsewhere), onto
    # x's placements; then each token's k terms, one after another from
    # zero
    place_t = [Partial() if i in ep else q for i, q in enumerate(place_x)]
    terms = from_shards(terms.view(tn // S, S, k, D), mesh, place_t,
                        (B, S, k, D)).redistribute(mesh, [
        Shard(q.dim + (q.dim > 1)) if q.is_shard() else Replicate()
        for q in x.placements])
    y = torch.zeros_like(terms[:, :, 0])
    for j in range(k):
        y = y + terms[:, :, j]
    return y, aux
