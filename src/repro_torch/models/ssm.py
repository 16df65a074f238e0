"""Mamba-2 (SSD, state-space duality) block, in PyTorch: the chunked
training scan and the O(1) recurrent decode.

Counterpart of ``repro/models/ssm.py``.  Training and prefill split the
sequence into chunks of ``cfg.ssm_chunk``: within a chunk the quadratic
(attention-like) form, across chunks a loop that carries the (B, H, hd, N)
f32 state.  Decode is the recurrence S <- a S + dt B x^T, y = C.S, with a
ring of the last K - 1 conv inputs; it writes the state and the ring into
the cache it is given, in place.

The casts are the reference's: the intra-chunk product takes bf16 operands
and accumulates in f32, everything else runs in f32, and the chunk's
cumulative log-decay adds in XLA's order (``sketch.blocked_cumsum``).
"""
from __future__ import annotations

import functools
from typing import Mapping, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Replicate, Shard

from ..core.sketch import blocked_cumsum
from ..dtensor import from_shards, is_dtensor, meta_if_fake, placements
from . import layers
from .config import ModelConfig


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over the sequence in f32, in x's dtype.
    x: (B, L, C); w: (K, C); b: (C,)."""
    if is_dtensor(x):
        return _causal_conv_local(x, w, b)
    K, C = w.shape
    xp = F.pad(x.float().transpose(1, 2), (K - 1, 0))            # (B, C, L+K-1)
    out = F.conv1d(xp, w.float().t()[:, None, :], groups=C)      # (B, C, L)
    return (out.transpose(1, 2) + b.float()).to(x.dtype)


def _causal_conv_local(x, w, b):
    """``_causal_conv`` of DTensors on each rank's shard: the grouped conv
    has no sharding rule, and a depthwise conv is independent across
    channels and batch rows, so x keeps its batch shard and takes the
    weight's channel shard."""
    mesh = x.device_mesh
    px, pw, pb = [], [], []
    for i, p in enumerate(w.placements):
        if p.is_shard() and p.dim == 1:
            px.append(Shard(2)), pw.append(p), pb.append(Shard(0))
        else:
            q = x.placements[i]
            px.append(q if q.is_shard() and q.dim == 0 else Replicate())
            pw.append(Replicate()), pb.append(Replicate())
    out = _causal_conv(x.redistribute(mesh, px).to_local(),
                       w.redistribute(mesh, pw).to_local(),
                       b.redistribute(mesh, pb).to_local())
    return from_shards(out, mesh, px, x.shape)


def _split_proj(p: Mapping[str, torch.Tensor], x: torch.Tensor,
                cfg: ModelConfig):
    d_in, N = cfg.d_inner, cfg.ssm_state
    zxbcdt = layers.whole_seq_grad(x @ p["in_proj"])
    z = zxbcdt[..., :d_in]
    xs = zxbcdt[..., d_in:2 * d_in]
    Bc = zxbcdt[..., 2 * d_in:2 * d_in + N]
    Cc = zxbcdt[..., 2 * d_in + N:2 * d_in + 2 * N]
    dt = zxbcdt[..., 2 * d_in + 2 * N:]
    return z, xs, Bc, Cc, dt


def _gated_out(p: Mapping[str, torch.Tensor], y: torch.Tensor,
               z: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The gated RMSNorm of y by silu(z), then the output projection."""
    g = y * F.silu(z.float())
    g = g * torch.rsqrt((g * g).mean(-1, keepdim=True) + 1e-6)
    g = g * p["out_norm"].float()
    return g.to(dtype) @ p["out_proj"]


def _chunk_step(S: torch.Tensor, xck, Bck, Cck, dtk, lak):
    """One chunk: (the state after it, its outputs (B, cl, H, hd)).
    xck (B, cl, H, hd), Bck and Cck (B, cl, N), dtk and lak (B, cl, H),
    all f32; S (B, H, hd, N) f32."""
    cl = xck.shape[1]
    cum = blocked_cumsum(lak.transpose(1, 2)).transpose(1, 2)      # (B, cl, H)
    # intra-chunk quadratic form: bf16 operands, f32 accumulation
    scores = torch.einsum("btn,bsn->bts", Cck, Bck)                # (B, cl, cl)
    tri = torch.ones((cl, cl), dtype=torch.bool,
                     device=xck.device).tril()[None, :, :, None]
    # the decay from s to t, masked above the diagonal before the exp:
    # there cum_t - cum_s > 0 overflows to inf once a chunk's decay passes
    # e^88, and a mask after the exp gives its zero gradient times inf
    # (NaN) in the backward, as the reference's does
    Lmat = torch.exp(torch.where(tri, cum[:, :, None, :] - cum[:, None, :, :],
                                 -torch.inf))                      # (B,t,s,H)
    M = torch.where(tri, scores[..., None] * Lmat, 0.0)
    Mdt = (M * dtk[:, None, :, :]).to(torch.bfloat16).float()
    y_intra = torch.einsum("btsh,bshp->bthp", Mdt,
                           xck.to(torch.bfloat16).float())
    # inter-chunk: the state flows in, decayed from the chunk's start
    y_inter = torch.einsum("btn,bhpn->bthp", Cck, S) \
        * torch.exp(cum)[..., None]
    # state update: outer products decayed to the chunk's end (f32)
    dte = dtk * torch.exp(cum[:, -1:, :] - cum)                    # (B, cl, H)
    S_add = torch.einsum("bshp,bsn->bhpn", dte[..., None] * xck, Bck)
    S_new = S * torch.exp(cum[:, -1])[:, :, None, None] + S_add
    return S_new, y_intra + y_inter


def _scan(xh, Bf, Cf, dt, la, cl: int, nc: int, cfg=None):
    """The chunk loop from a zero state: (y (B, L, H, hd), the final state
    (B, H, hd, N)), all f32."""
    B, _, H, hd = xh.shape
    S = torch.zeros((B, H, hd, Bf.shape[-1]), dtype=torch.float32,
                    device=xh.device)
    ys = []
    for c in range(nc):
        t = slice(c * cl, (c + 1) * cl)
        S, y_c = _chunk_step(S, xh[:, t], Bf[:, t], Cf[:, t], dt[:, t],
                             la[:, t])
        ys.append(y_c)
    return torch.cat(ys, dim=1), S


def _scan_local(xh, Bf, Cf, dt, la, cl: int, nc: int, cfg):
    """``_scan`` of DTensors on each rank's shard: the chunk loop slices
    the sequence and pads its cumsums, which DTensor would redistribute
    at every chunk; the scan is independent across batch rows and heads,
    so each rank scans its batch rows and heads (over the TP axis where
    it divides the heads) with the sequence whole."""
    mesh = xh.device_mesh
    B, L, H, hd = xh.shape
    b = layers._batch_entry(B, cfg)
    tp = dict(zip(mesh.mesh_dim_names, mesh.shape)).get(cfg.sp_axis, 1)
    h = cfg.sp_axis if cfg.sp_axis and H % tp == 0 else None

    def local(t, spec):
        return t.redistribute(mesh, placements(spec, mesh)).to_local()

    # without autograd (prefill) a dry-run's fake shards scan as meta
    # tensors: ~25 us an op against ~0.7 ms (``dtensor.meta_if_fake``)
    run = _scan if torch.is_grad_enabled() else functools.partial(
        meta_if_fake, _scan)
    y, S = run(local(xh, (b, None, h, None)), local(Bf, (b, None, None)),
               local(Cf, (b, None, None)), local(dt, (b, None, h)),
               local(la, (b, None, h)), cl, nc)
    return (from_shards(y, mesh, placements((b, None, h, None), mesh),
                        xh.shape),
            from_shards(S, mesh, placements((b, h, None, None), mesh),
                        (B, H, hd, Bf.shape[-1])))


def ssd_forward(p: Mapping[str, torch.Tensor], x: torch.Tensor,
                cfg: ModelConfig, return_state: bool = False):
    """Training/prefill forward.  x: (B, L, D); pads to whole chunks.

    ``return_state=True`` also returns (ssm state (B, H, hd, N) f32, conv
    state) from the same scan; the conv state is the last K - 1 conv
    inputs, ``conv_in[:, L - (K - 1):L]`` as the reference slices it, so a
    prompt shorter than K - 1 leaves fewer rows and the next
    ``ssd_decode`` raises, as the reference's does."""
    B, L, _ = x.shape
    d_in, N, H, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    cl = min(cfg.ssm_chunk, L)
    L_orig = L
    pad = (-L) % cl
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        L = L + pad
    nc = L // cl

    z, xs, Bc, Cc, dt = _split_proj(p, x, cfg)
    conv_in = torch.cat([xs, Bc, Cc], dim=-1)
    conv_out = F.silu(_causal_conv(conv_in, p["conv_w"], p["conv_b"]))
    xs = conv_out[..., :d_in]
    Bc = conv_out[..., d_in:d_in + N]
    Cc = conv_out[..., d_in + N:]

    dt = F.softplus(dt.float() + p["dt_bias"].float())
    if pad:
        # padded steps: dt = 0, so decay 1 and no state contribution
        step_ok = (torch.arange(L, device=x.device) < L_orig)[None, :, None]
        dt = torch.where(step_ok, dt, 0.0)
    A = -torch.exp(p["A_log"].float())                             # (H,)
    la = dt * A                                                    # (B, L, H)

    xh = xs.reshape(B, L, H, hd).float()
    scan = _scan_local if is_dtensor(xh) else _scan
    y, S = scan(xh, Bc.float(), Cc.float(), dt, la, cl, nc, cfg)
    y = y + p["D"].float()[None, None, :, None] * xh
    y = y.reshape(B, L, d_in)[:, :L_orig]
    out = _gated_out(p, y, z[:, :L_orig], x.dtype)
    if return_state:
        K = cfg.ssm_conv
        # a copy of the last K - 1 rows: a view would keep the whole
        # (B, L, C) conv input of every layer alive until the states stack
        return out, (S, conv_in[:, L_orig - (K - 1):L_orig].clone())
    return out


def ssd_decode(p: Mapping[str, torch.Tensor], x: torch.Tensor,
               cfg: ModelConfig, cache: dict
               ) -> Tuple[torch.Tensor, dict]:
    """One recurrent step.  x: (B, 1, D); cache: {"ssm": (B, H, hd, N) f32,
    "conv": (B, K - 1, d_in + 2N)}, which this step overwrites in place
    with the new state and the ring shifted by one.  Returns (out (B, 1,
    D), the cache)."""
    B = x.shape[0]
    d_in, N, H, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    K = cfg.ssm_conv

    z, xs, Bc, Cc, dt = _split_proj(p, x, cfg)
    conv_in = torch.cat([xs, Bc, Cc], dim=-1)[:, 0]                # (B, C)
    hist = torch.cat([cache["conv"], conv_in[:, None]], dim=1)     # (B, K, C)
    if hist.shape[1] != K:
        raise ValueError(f"conv state holds {hist.shape[1] - 1} rows, the "
                         f"conv takes {K - 1}: a prompt shorter than "
                         f"ssm_conv - 1 = {K - 1} tokens")
    conv_out = torch.einsum("bkc,kc->bc", hist.float(), p["conv_w"].float()) \
        + p["conv_b"].float()
    conv_out = F.silu(conv_out)

    xs1 = conv_out[:, :d_in]
    B1 = conv_out[:, d_in:d_in + N]
    C1 = conv_out[:, d_in + N:]
    dt1 = F.softplus(dt[:, 0].float() + p["dt_bias"].float())      # (B, H)
    A = -torch.exp(p["A_log"].float())
    a = torch.exp(dt1 * A)                                         # (B, H)
    xh = xs1.reshape(B, H, hd).float()
    S = cache["ssm"] * a[:, :, None, None] \
        + (dt1[:, :, None] * xh)[..., None] * B1[:, None, None, :]
    y = torch.einsum("bn,bhpn->bhp", C1, S)
    y = y + p["D"].float()[None, :, None] * xh
    cache["ssm"].copy_(S)
    cache["conv"].copy_(hist[:, 1:])
    out = _gated_out(p, y.reshape(B, 1, d_in), z, x.dtype)
    return out, cache


def ssd_reference(p: Mapping[str, torch.Tensor], x: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    """Sequential-scan oracle (L decode steps from a zero state) for
    testing the chunked path."""
    B, L, _ = x.shape
    H, hd, N, K = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_conv
    cache = {"ssm": torch.zeros((B, H, hd, N), dtype=torch.float32,
                                device=x.device),
             "conv": torch.zeros((B, K - 1, cfg.d_inner + 2 * N),
                                 dtype=x.dtype, device=x.device)}
    outs = []
    for t in range(L):
        o, cache = ssd_decode(p, x[:, t:t + 1], cfg, cache)
        outs.append(o)
    return torch.cat(outs, dim=1)
