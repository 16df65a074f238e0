"""Core neural layers, in PyTorch: norms, rotary embeddings (RoPE and
Qwen2-VL's M-RoPE), grouped-query attention (the decode path, the direct
path and a blockwise online-softmax path for long sequences, with a
blockwise backward) and the MLPs.

Counterpart of ``repro/models/layers.py``.  Layers are plain
functions of tensors; a block's weights come in a mapping by the JAX names
(``wq``, ``wk``, ``wv``, ``wo``, ``ln1``, ``w_gate``, ...), which
``model.DenseBlock`` holds.  The casts are the reference's, so the two
packages differ by rounding only: the decode path takes q, the cache and the
probabilities to bf16 with f32 accumulation, the direct and blockwise paths
run in f32, and masks are an additive ``NEG_INF`` bias (a fully masked row
softmaxes over its raw scores, it does not give NaN).
"""
from __future__ import annotations

from typing import Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from .config import ModelConfig

NEG_INF = -1e30
UNWRITTEN = 2 ** 30       # cache position of a slot never written


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    return (x * w.float()).to(dt)


def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * w.float() + b.float()).to(dt)


def norm(x: torch.Tensor, p: Mapping[str, torch.Tensor], cfg: ModelConfig,
         key: str) -> torch.Tensor:
    if cfg.use_layernorm:
        return layernorm(x, p[key], p[key + "_b"])
    return rmsnorm(x, p[key])


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------


def rope_freqs(d_head: int, theta: float, device=None) -> torch.Tensor:
    """1 / theta^(2i/d_head) in f32.  The power is taken in f64 and rounded
    once, as a correctly rounded f32 ``pow`` gives it."""
    e = torch.arange(0, d_head, 2, dtype=torch.float32, device=device) / d_head
    return 1.0 / (float(theta) ** e.double()).float()


def rope_angles(positions: torch.Tensor, d_head: int,
                theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos and sin of the rotary angles, each (B, S, 1, d_head/2) f32, for
    positions (B, S).  Computed once for q and k, and once a decode step
    for every layer."""
    inv = rope_freqs(d_head, theta, positions.device)      # (dh/2,)
    ang = positions[..., None].float() * inv               # (B, S, dh/2)
    return torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float, *,
               angles: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
               ) -> torch.Tensor:
    """x: (B, S, H, dh); positions: (B, S) int32, or their ``rope_angles``.
    The head splits in halves (x1, x2), not in interleaved pairs; angles
    are f32."""
    cos, sin = angles or rope_angles(positions, x.shape[-1], theta)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def mrope_angles(positions3: torch.Tensor, d_head: int, theta: float,
                 sections: Tuple[int, ...]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Qwen2-VL's M-RoPE angles: the d_head/2 frequency slots split into
    the (temporal, height, width) ``sections``, each slot rotated by its
    section's stream of ``positions3`` (3, B, S).  cos and sin, each (B, S,
    1, d_head/2) f32; equal streams give ``rope_angles`` bit for bit."""
    if sum(sections) != d_head // 2:
        raise ValueError(f"M-RoPE sections {sections} do not cover "
                         f"d_head/2 = {d_head // 2} slots")
    inv = rope_freqs(d_head, theta, positions3.device)     # (dh/2,)
    sec = torch.cat([torch.full((s,), i, dtype=torch.long)
                     for i, s in enumerate(sections)]).to(positions3.device)
    pos = positions3.float()[sec]                          # (dh/2, B, S)
    ang = pos.permute(1, 2, 0) * inv                       # (B, S, dh/2)
    return torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections: Tuple[int, ...]) -> torch.Tensor:
    """x: (B, S, H, dh) rotated by M-RoPE over positions3 (3, B, S) int32
    (equal streams for text)."""
    return apply_rope(x, None, theta, angles=mrope_angles(
        positions3, x.shape[-1], theta, sections))


# ---------------------------------------------------------------------------
# grouped-query attention
# ---------------------------------------------------------------------------


def _mask_bias(pos_q: torch.Tensor, pos_k: torch.Tensor,
               kv_len: Optional[torch.Tensor], causal: bool,
               window: int) -> torch.Tensor:
    """(B, Sq, Sk) f32 additive bias: 0 where attendable, NEG_INF elsewhere.
    Masks use absolute positions, never slot indices."""
    pq = pos_q[:, :, None]         # (B, Sq, 1)
    pk = pos_k[:, None, :]         # (B, 1, Sk)
    if kv_len is not None:
        ok = pk < kv_len[:, None, None]
    else:
        ok = torch.ones(pq.shape[:2] + pk.shape[2:], dtype=torch.bool,
                        device=pk.device)
    if causal:
        ok = ok & (pk <= pq)
    if window:
        ok = ok & (pq - pk < window)
    return torch.where(ok, 0.0, NEG_INF)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              pos_q: torch.Tensor, pos_k: torch.Tensor, *,
              causal: bool = True, window: int = 0,
              kv_len: Optional[torch.Tensor] = None,
              q_block: int = 512, kv_block: int = 1024,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GQA attention.  q: (B, Sq, NH, dh); k, v: (B, Sk, KV, dh); pos_*:
    (B, S*) absolute positions.  Returns (B, Sq, NH, dh) in q's dtype.

    Sq == 1 is the decode path (grouped heads, bf16 operands, f32
    accumulation); a problem of at most ``q_block * kv_block * 2`` scores
    the direct f32 path; anything larger the blockwise online softmax of
    ``_flash``, which masks through positions only (``kv_len`` must be
    None there).  ``bias``, where given, is these positions' ``_mask_bias``
    for the decode and direct paths (a decode step builds it once for
    every layer)."""
    B, Sq, NH, dh = q.shape
    _, Sk, KV, _ = k.shape
    G = NH // KV

    if Sq == 1:
        # a fill on the device: a host tensor copied over would sync
        scale = torch.full((), dh ** -0.5, dtype=torch.bfloat16,
                           device=q.device)
        qg = (q.to(torch.bfloat16) * scale).reshape(B, Sq, KV, G, dh)
        s = torch.einsum("bqkgd,btkd->bkgqt", qg.float(),
                         k.to(torch.bfloat16).float())
        if bias is None:
            bias = _mask_bias(pos_q, pos_k, kv_len, causal, window)
        s = s + bias[:, None, None]
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(-1, keepdim=True)
        o = torch.einsum("bkgqt,btkd->bqkgd",
                         (p / l).to(torch.bfloat16).float(),
                         v.to(torch.bfloat16).float())
        return o.reshape(B, Sq, NH, dh).to(q.dtype)

    if G > 1:
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)

    if Sq * Sk <= q_block * kv_block * 2:
        qs = q.float() * dh ** -0.5
        s = torch.einsum("bqhd,bthd->bhqt", qs, k.float())
        if bias is None:
            bias = _mask_bias(pos_q, pos_k, kv_len, causal, window)
        s = s + bias[:, None]
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhqt,bthd->bqhd", p, v.float())
        return o.to(q.dtype)

    if kv_len is not None:
        raise ValueError("the blockwise path masks through position "
                         "sentinels; kv_len must be None")
    return _flash(q, k, v, pos_q, pos_k, causal, window, q_block, kv_block)


# ---------------------------------------------------------------------------
# blockwise attention with a blockwise backward
#
# Autograd through the loops below would keep every (B, NH, q_block,
# kv_block) probability block for the backward (the reference measured about
# 2 GB a layer that way).  ``_Flash`` saves (q, k, v, positions, out, lse)
# and its backward recomputes the probabilities block by block, as the
# reference's custom_vjp (``_flash_fwd``/``_flash_bwd``) and the
# FlashAttention-2 kernel do.
# ---------------------------------------------------------------------------


def _blockify(q, k, v, pos_q, pos_k, q_block: int, kv_block: int):
    """q, k and v in f32, queries padded to whole q blocks at position -1,
    keys and values to whole kv blocks at position 2^30
    (``_block_bias`` masks those keys)."""
    Sq, Sk = q.shape[1], k.shape[1]
    nq, nk = -(-Sq // q_block), -(-Sk // kv_block)
    qp = F.pad(q.float(), (0, 0, 0, 0, 0, nq * q_block - Sq))
    kp = F.pad(k.float(), (0, 0, 0, 0, 0, nk * kv_block - Sk))
    vp = F.pad(v.float(), (0, 0, 0, 0, 0, nk * kv_block - Sk))
    pq = F.pad(pos_q, (0, nq * q_block - Sq), value=-1)
    pk = F.pad(pos_k, (0, nk * kv_block - Sk), value=UNWRITTEN)
    return qp, kp, vp, pq, pk, nq, nk


def _block_bias(pq, pk, Sk: int, j: int, kv_block: int, causal: bool,
                window: int) -> torch.Tensor:
    """The mask bias of kv block ``j`` for the padded positions ``pq``
    (B, q_block) and ``pk`` (B, kv_block): ``_mask_bias``, with the keys
    past the Sk real ones (the padding) masked too.  The causal mask drops
    them through their position 2^30 already; a non-causal one would not,
    and zero keys would take softmax weight.  (The reference's
    ``_flash_fwd_impl`` and ``_flash_bwd`` do not mask them: its
    non-causal blockwise attention differs from its direct path whenever
    Sk is not a multiple of ``kv_block``.)"""
    bias = _mask_bias(pq, pk, None, causal, window)
    real = Sk - j * kv_block
    if real < kv_block:
        bias[..., real:] = NEG_INF
    return bias


def _flash_fwd_impl(q, k, v, pos_q, pos_k, causal: bool, window: int,
                    q_block: int, kv_block: int):
    """Blockwise online-softmax forward in f32 (the reference's
    ``_flash_fwd_impl``): one q block at a time, each over the kv blocks in
    turn, so a step holds (B, NH, q_block, kv_block) scores.  Returns out
    (B, Sq, NH, dh) f32 and the log-sum-exp of each row (B, NH, Sq)."""
    B, Sq, NH, dh = q.shape
    scale = dh ** -0.5
    qp, kp, vp, pq, pk, nq, nk = _blockify(q, k, v, pos_q, pos_k, q_block,
                                           kv_block)
    out = torch.empty(qp.shape, dtype=torch.float32, device=q.device)
    lse = torch.empty((B, NH, nq * q_block), dtype=torch.float32,
                      device=q.device)
    for i in range(nq):
        qs = slice(i * q_block, (i + 1) * q_block)
        qb = qp[:, qs] * scale
        m = torch.full((B, NH, q_block), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, NH, q_block, dh), dtype=torch.float32,
                          device=q.device)
        for j in range(nk):
            ks = slice(j * kv_block, (j + 1) * kv_block)
            s = torch.einsum("bqhd,bthd->bhqt", qb, kp[:, ks])
            s = s + _block_bias(pq[:, qs], pk[:, ks], k.shape[1], j,
                                kv_block, causal, window)[:, None]
            m2 = torch.maximum(m, s.amax(-1))
            corr = torch.exp(m - m2)
            p = torch.exp(s - m2[..., None])
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum("bhqt,bthd->bhqd", p,
                                                       vp[:, ks])
            m = m2
        l = torch.clamp(l, min=1e-30)
        out[:, qs] = (acc / l[..., None]).transpose(1, 2)
        lse[:, :, qs] = m + torch.log(l)
    return out[:, :Sq], lse[:, :, :Sq]


def _flash_bwd_impl(q, k, v, pos_q, pos_k, out, lse, dout, causal: bool,
                    window: int, q_block: int, kv_block: int):
    """The reference's ``_flash_bwd``: with D = rowsum(dout * out), a dQ
    pass over the q blocks (each reducing over the kv blocks), then a dK/dV
    pass over the kv blocks (each reducing over the q blocks), each
    recomputing P = exp(S - lse) a block at a time.  Returns f32 dq, dk,
    dv."""
    B, Sq, NH, dh = q.shape
    Sk = k.shape[1]
    scale = dh ** -0.5
    qp, kp, vp, pq, pk, nq, nk = _blockify(q, k, v, pos_q, pos_k, q_block,
                                           kv_block)
    pad = nq * q_block - Sq
    do = F.pad(dout.float(), (0, 0, 0, 0, 0, pad))
    lse = F.pad(lse, (0, pad))
    D = F.pad(torch.einsum("bqhd,bqhd->bhq", dout.float(), out.float()),
              (0, pad))

    def blocks(i: int, j: int):
        """P and dS = P * (dP - D) of one (q block, kv block) pair, each
        (B, NH, q_block, kv_block), built in place: two blocks live."""
        qs = slice(i * q_block, (i + 1) * q_block)
        ks = slice(j * kv_block, (j + 1) * kv_block)
        p = torch.einsum("bqhd,bthd->bhqt", qp[:, qs] * scale, kp[:, ks])
        p += _block_bias(pq[:, qs], pk[:, ks], Sk, j, kv_block, causal,
                         window)[:, None]
        p.sub_(lse[:, :, qs, None]).exp_()
        ds = torch.einsum("bqhd,bthd->bhqt", do[:, qs], vp[:, ks])
        ds.sub_(D[:, :, qs, None]).mul_(p)
        return p, ds

    dq = torch.empty_like(qp)
    for i in range(nq):
        qs = slice(i * q_block, (i + 1) * q_block)
        acc = torch.zeros((B, q_block, NH, dh), dtype=torch.float32,
                          device=q.device)
        for j in range(nk):
            ks = slice(j * kv_block, (j + 1) * kv_block)
            ds = blocks(i, j)[1]
            acc += torch.einsum("bhqt,bthd->bqhd", ds, kp[:, ks]) * scale
            del ds
        dq[:, qs] = acc
    dk, dv = torch.empty_like(kp), torch.empty_like(vp)
    for j in range(nk):
        ks = slice(j * kv_block, (j + 1) * kv_block)
        dk_a = torch.zeros((B, kv_block, NH, dh), dtype=torch.float32,
                           device=q.device)
        dv_a = torch.zeros_like(dk_a)
        for i in range(nq):
            qs = slice(i * q_block, (i + 1) * q_block)
            p, ds = blocks(i, j)
            dv_a += torch.einsum("bhqt,bqhd->bthd", p, do[:, qs])
            dk_a += torch.einsum("bhqt,bqhd->bthd", ds, qp[:, qs]) * scale
            del p, ds
        dk[:, ks], dv[:, ks] = dk_a, dv_a
    return dq[:, :Sq], dk[:, :Sk], dv[:, :Sk]


class _Flash(torch.autograd.Function):
    """Blockwise attention whose backward recomputes the probabilities;
    positions get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, pos_q, pos_k, causal, window, q_block,
                kv_block):
        out, lse = _flash_fwd_impl(q, k, v, pos_q, pos_k, causal, window,
                                   q_block, kv_block)
        ctx.save_for_backward(q, k, v, pos_q, pos_k, out, lse)
        ctx.blocking = (causal, window, q_block, kv_block)
        return out.to(q.dtype)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, k, v, pos_q, pos_k, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd_impl(q, k, v, pos_q, pos_k, out, lse, dout,
                                     *ctx.blocking)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None, None, None)


def _flash(q, k, v, pos_q, pos_k, causal: bool, window: int, q_block: int,
           kv_block: int) -> torch.Tensor:
    """Blockwise attention (q, k and v at the same head count), in q's
    dtype, differentiable in q, k and v."""
    return _Flash.apply(q, k, v, pos_q, pos_k, causal, window, q_block,
                        kv_block)


# ---------------------------------------------------------------------------
# attention block (projection + rope + attention + output)
# ---------------------------------------------------------------------------


def attn_block(p: Mapping[str, torch.Tensor], x: torch.Tensor,
               cfg: ModelConfig, *, positions: torch.Tensor,
               positions3: Optional[torch.Tensor] = None,
               cache: Optional[dict] = None,
               kv_len: Optional[torch.Tensor] = None,
               angles: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
               bias: Optional[torch.Tensor] = None, causal: bool = True,
               xkv: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Attention sub-block.  With ``cache`` ({"k", "v": (B, S_cache, KV,
    dh), "pos": (B, S_cache) int32}), writes this call's K/V and their
    absolute positions at slot ``kv_len[0]`` (the whole batch's, clamped so
    that the write fits, as ``dynamic_update_slice`` clamps; slot 0 when
    ``kv_len`` is None) **in place**, then attends over the whole cache.
    A prompt longer than the cache (a sliding-window ring) writes its last
    S_cache positions at slot 0, and every query then attends over that
    cache alone, as the reference does: queries before the last window do
    not see their own window.  ``angles`` (``rope_angles`` of
    ``positions``) and ``bias`` (the attention's ``_mask_bias`` over the
    cache after this call's write) may come precomputed, as a decode step
    passes them to every layer.  An M-RoPE config with ``positions3``
    (3, B, S) rotates by ``mrope_angles``; the mask still reads
    ``positions``.

    ``xkv`` (B, Sk, D) makes it a cross-attention: K/V are ``xkv @ wk`` and
    ``xkv @ wv``, nothing is rotated, and the keys sit at positions
    0..Sk-1 (the encoder-decoder passes ``causal=False``)."""
    B, S, D = x.shape
    NH, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    src = x if xkv is None else xkv
    Sk = src.shape[1]
    q = (x @ p["wq"]).reshape(B, S, NH, dh)
    k = (src @ p["wk"]).reshape(B, Sk, KV, dh)
    v = (src @ p["wv"]).reshape(B, Sk, KV, dh)
    if xkv is None:
        if angles is None and cfg.mrope and positions3 is not None:
            angles = mrope_angles(positions3, dh, cfg.rope_theta,
                                  cfg.mrope_sections)
        angles = angles or rope_angles(positions, dh, cfg.rope_theta)
        q = apply_rope(q, positions, cfg.rope_theta, angles=angles)
        k = apply_rope(k, positions, cfg.rope_theta, angles=angles)
    kw = dict(causal=causal, window=cfg.swa_window, q_block=cfg.attn_q_block,
              kv_block=cfg.attn_kv_block)

    if cache is not None:
        ck, cv, cpos = cache["k"], cache["v"], cache["pos"]
        S_cache = ck.shape[1]
        if S > S_cache:
            k_w, v_w = k[:, -S_cache:], v[:, -S_cache:]
            p_w = positions[:, -S_cache:]
        else:
            k_w, v_w, p_w = k, v, positions
        S_w = k_w.shape[1]
        if kv_len is None or S > S_cache:
            ck[:, :S_w] = k_w
            cv[:, :S_w] = v_w
            cpos[:, :S_w] = p_w
        else:
            # a device-side slot (no host sync), clamped as the reference's
            # dynamic_update_slice clamps its start
            idx = kv_len[:1].long().clamp(0, S_cache - S_w) + torch.arange(
                S_w, device=x.device)
            ck.index_copy_(1, idx, k_w.to(ck.dtype))
            cv.index_copy_(1, idx, v_w.to(cv.dtype))
            cpos.index_copy_(1, idx, p_w.to(torch.int32))
        out = attention(q, ck, cv, positions, cpos, bias=bias, **kw)
        new_cache = cache
    else:
        pos_k = positions if xkv is None else torch.arange(
            Sk, dtype=torch.int32, device=x.device).expand(B, Sk)
        out = attention(q, k, v, positions, pos_k, **kw)
        new_cache = None
    return out.reshape(B, S, NH * dh) @ p["wo"], new_cache


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def mlp_block(p: Mapping[str, torch.Tensor], x: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    if cfg.mlp_type == "swiglu":
        return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
    return F.gelu(x @ p["w_in"], approximate="tanh") @ p["w_down"]
