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
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..dtensor import from_shards, meta_if_fake, placements, shard_range
from .config import ModelConfig

NEG_INF = -1e30
UNWRITTEN = 2 ** 30       # cache position of a slot never written


# ---------------------------------------------------------------------------
# distribution: the reference's sharding constraints as DTensor
# redistributions on the mesh a DTensor carries (the step builders place
# the parameters and inputs; ``ModelConfig`` keeps the reference's fields
# and names no mesh)
# ---------------------------------------------------------------------------


def _constrain(x: torch.Tensor, spec: tuple) -> torch.Tensor:
    """``x`` redistributed to ``spec`` on its mesh (a plain tensor passes
    through)."""
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, placements(spec, x.device_mesh))


def gather_dims(x: torch.Tensor, dims: Tuple[int, ...] = ()) -> torch.Tensor:
    """A DTensor with dims ``dims`` gathered whole and its pending partial
    sums reduced (with no dims: the sums alone, so that an indexing op
    after it sees whole values); a plain tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    place = [Replicate() if p.is_partial() or (p.is_shard() and p.dim in dims)
             else p for p in x.placements]
    return x.redistribute(x.device_mesh, place)


def whole_seq(x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """A (B, S, ...) DTensor with the sequence gathered (and pending sums
    reduced) before a projection: Megatron-SP's all-gather ahead of the
    column-parallel matmul.  Merging a batch shard and a sequence shard
    in the matmul's reshape would make a strided shard, whose
    redistributions DTensor plans by a graph search (seconds a matmul on
    a 3-D mesh).  A plain tensor, or None, as it is."""
    return gather_dims(x, (1,)) if x is not None else x


def _own_shard(dst: DTensor, src: torch.Tensor) -> tuple:
    """(dst's local shard, src placed as dst with dim 1 whole, the first
    index and length of dst's shard of dim 1), for a write into the slots
    of dim 1 that this rank holds."""
    mesh = dst.device_mesh
    place = [Replicate() if p.is_partial() or (p.is_shard() and p.dim == 1)
             else p for p in dst.placements]
    if not isinstance(src, DTensor):
        src = DTensor.from_local(src, mesh, (Replicate(),) * mesh.ndim,
                                 run_check=False)
    return (dst.to_local(), src.redistribute(mesh, place).to_local(),
            *shard_range(dst.shape[1], mesh, dst.placements, 1))


def _write_slots(dst: torch.Tensor, idx: torch.Tensor,
                 src: torch.Tensor) -> None:
    """``dst[:, idx] = src`` in place, in dst's dtype.  ``index_copy_``
    has no sharding rule for a DTensor split along dim 1 (a decode
    cache's sequence): each rank writes the slots its shard holds and
    keeps the rest, with no communication (one slot a call)."""
    if not isinstance(dst, DTensor):
        dst.index_copy_(1, idx, src.to(dst.dtype))
        return
    if idx.numel() != 1:
        raise ValueError("a sharded cache takes one slot a write")
    local, new, start, n = _own_shard(dst, src)
    if n == 0:
        return
    at = whole(idx).to(torch.long) - start
    mine = ((at >= 0) & (at < n)).reshape((1, 1) + (1,) * (local.ndim - 2))
    at = at.clamp(0, n - 1)
    local.index_copy_(1, at, torch.where(mine, new.to(local.dtype),
                                         local.index_select(1, at)))


def _write_prefix(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst[:, :n] = src`` in place, n = ``src.shape[1]``.  A DTensor
    split along dim 1 (the cache of a batch that the batch axes do not
    divide splits its sequence there) cannot take a slice's write: DTensor
    gathers the slice into a copy and writes that.  Each rank writes the
    slots its shard holds instead, with no communication."""
    if not (isinstance(dst, DTensor)
            and any(p.is_shard() and p.dim == 1 for p in dst.placements)):
        dst[:, :src.shape[1]] = src
        return
    local, new, start, n = _own_shard(dst, src)
    stop = min(start + n, src.shape[1])
    if stop > start:
        local[:, :stop - start] = new[:, start:stop].to(local.dtype)


def heads_view(t: torch.Tensor, *shape: int) -> torch.Tensor:
    """``t.reshape(shape)``, splitting dim 2 into (heads, dh) or merging
    them back.  A DTensor whose dim 2 is split into pieces that do not
    divide the head count (12 or 56 heads, or 8 KV heads, over 16) is
    gathered there first: DTensor cannot view uneven head shards."""
    if isinstance(t, DTensor):
        heads = shape[2] if len(shape) > t.ndim else t.shape[2]
        n = 1
        for i, p in enumerate(t.placements):
            if p.is_shard() and p.dim == 2:
                n *= t.device_mesh.size(i)
        if heads % n:
            # the view on each rank's shard (dims 0 and 1 keep theirs), so
            # that its backward views the gradient locally too
            t = gather_dims(t, (2,))
            local = t.to_local()
            local = local.reshape(*local.shape[:2], *shape[2:])
            return from_shards(local, t.device_mesh, t.placements, shape)
    return t.reshape(*shape)


def whole(x: torch.Tensor) -> torch.Tensor:
    """A DTensor gathered whole onto every rank, as a plain tensor (for an
    op without a sharding rule); a plain tensor as it is."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def _batch_entry(n: int, cfg: ModelConfig):
    return cfg.batch_axes if (cfg.batch_axes and n % cfg.dp_size == 0) \
        else None


def batch_whole(p: Mapping[str, torch.Tensor], x: torch.Tensor,
                cfg: ModelConfig) -> Mapping[str, torch.Tensor]:
    """A block's weights ``p`` with their shards on the batch axes
    gathered (FSDP's all-gather) where ``x``'s batch is one that those
    axes do not divide (3 rows over a "data" axis of 2); ``p`` as it is
    otherwise, and off a mesh.  Such a batch stays whole on the batch
    axes (``shard_act``), and DTensor's product would split the weight's
    contracting d_model there instead: its partial sums, scattered over
    the batch by the next nonlinearity, make an uneven batch shard that
    no later view can flatten."""
    if (not cfg.batch_axes or not isinstance(x, DTensor)
            or _batch_entry(x.shape[0], cfg) is not None):
        return p
    out = {}
    for name, w in p.items():
        if isinstance(w, DTensor):
            names = w.device_mesh.mesh_dim_names
            place = [Replicate() if names[i] in cfg.batch_axes else q
                     for i, q in enumerate(w.placements)]
            w = w.redistribute(w.device_mesh, place)
        out[name] = w
    return out


def shard_act(x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Residual-stream constraint between blocks.  Identity off-mesh and
    for a config without distribution hints.

    Dense/attention families: sequence-parallel, (B, S, D) ->
    (batch, sp_axis, None) — Megatron-SP, norms/MLP input stays sharded.

    SSM/hybrid families: feature-parallel, (batch, None, sp_axis) — the SSD
    chunk scan slices the sequence axis every step, so a seq-sharded stream
    would reshard once per chunk per layer; keeping D sharded makes
    in_proj a row-parallel matmul instead.  Skips batch sharding when B
    doesn't divide (long_500k B=1)."""
    if not cfg.batch_axes and not cfg.sp_axis:
        return x
    if x.ndim != 3:
        return x
    b_spec = _batch_entry(x.shape[0], cfg)
    if cfg.family in ("ssm", "hybrid"):
        d_spec = cfg.sp_axis if (cfg.sp_axis and x.shape[2] % 16 == 0) \
            else None
        return _constrain(x, (b_spec, None, d_spec))
    s_spec = cfg.sp_axis if (cfg.sp_axis and x.shape[1] % 16 == 0) else None
    return _constrain(x, (b_spec, s_spec, None))


def shard_heads(t: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Tensor-parallel constraint on (B, S, H, dh): heads over the TP axis
    (a head count that does not divide splits unevenly — e.g. 56 or 12
    over 16)."""
    if not cfg.sp_axis:
        return t
    return _constrain(t, (_batch_entry(t.shape[0], cfg), None, cfg.sp_axis,
                          None))


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
              bias: Optional[torch.Tensor] = None,
              cfg: Optional[ModelConfig] = None) -> torch.Tensor:
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
        # on a mesh the grouped (KV, G) split needs whole heads: KV may not
        # divide the TP axis
        q = gather_dims(q, (2,))
        # and whole dh in the keys (a prefill cache splits it, as a decode
        # cache does where "model" does not divide its slots): the scores'
        # partial sums would otherwise be scattered over a batch that the
        # mesh may not divide
        k = gather_dims(k, (3,))
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
        # on a mesh: the sums over the split sequence reduced, the heads
        # whole, only the batch split kept (one token: a small gather)
        o = gather_dims(o, (1, 2, 3, 4))
        return o.reshape(B, Sq, NH, dh).to(q.dtype)

    if G > 1:
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    if cfg is not None:
        q = shard_heads(q, cfg)
        k = shard_heads(k, cfg)
        v = shard_heads(v, cfg)

    if Sq * Sk <= q_block * kv_block * 2:
        if bias is None:
            bias = _mask_bias(pos_q, pos_k, kv_len, causal, window)
        if isinstance(q, DTensor):
            return _on_shards(_direct, (q, k, v), (bias,))
        return _direct(q, k, v, bias)

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
        out, lse = meta_if_fake(_flash_fwd_impl, q, k, v, pos_q, pos_k,
                                 causal, window, q_block, kv_block)
        ctx.save_for_backward(q, k, v, pos_q, pos_k, out, lse)
        ctx.blocking = (causal, window, q_block, kv_block)
        return out.to(q.dtype)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, k, v, pos_q, pos_k, out, lse = ctx.saved_tensors
        dq, dk, dv = meta_if_fake(_flash_bwd_impl, q, k, v, pos_q, pos_k,
                                   out, lse, dout, *ctx.blocking)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None, None, None)


def _direct(q, k, v, bias) -> torch.Tensor:
    """The direct path in f32: every score at once, the additive mask
    ``bias`` (B, Sq, Sk)."""
    qs = q.float() * q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bthd->bhqt", qs, k.float())
    s = s + bias[:, None]
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqt,bthd->bqhd", p, v.float())
    return o.to(q.dtype)


def _flash(q, k, v, pos_q, pos_k, causal: bool, window: int, q_block: int,
           kv_block: int) -> torch.Tensor:
    """Blockwise attention (q, k and v at the same head count), in q's
    dtype, differentiable in q, k and v.  DTensors run on each rank's
    shard (``_on_shards``): ``_Flash`` has no sharding rule."""
    def run(q, k, v, pos_q, pos_k):
        return _Flash.apply(q, k, v, pos_q, pos_k, causal, window, q_block,
                            kv_block)
    if isinstance(q, DTensor):
        return _on_shards(run, (q, k, v), (pos_q, pos_k))
    return run(q, k, v, pos_q, pos_k)


class _WholeSeqGrad(torch.autograd.Function):
    """The identity, whose backward gathers the gradient's sequence (and
    reduces its partial sums)."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return whole_seq(g)


def whole_seq_grad(t: torch.Tensor) -> torch.Tensor:
    """``t`` (B, S, ...), whose gradient comes back with the sequence
    whole: a matmul's output, whose backward views the gradient flat,
    which torch 2.11's DTensor cannot do with the batch split over two
    mesh dimensions and the sequence over a third (the split that
    DTensor's matmul strategy may give the output).  A plain tensor as it
    is."""
    return _WholeSeqGrad.apply(t) if isinstance(t, DTensor) else t


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward makes the gradient contiguous: a local
    attention's q, k and v gradients come out of its einsums transposed,
    and torch 2.11's DTensor views them flat in the projections'
    backward."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _on_shards(fn, heads: tuple, rows: tuple) -> torch.Tensor:
    """``fn(*heads, *rows)`` of DTensors on each rank's shard, for the
    attention paths without a sharding rule (or, on torch 2.11, whose
    einsums cannot flatten a split batch and split heads): attention is
    independent across batch rows and heads, so ``heads`` (q, k, v:
    (B, S, H, dh)) keep q's batch and head shards and gather the rest
    (the sequence, dh), and ``rows`` (positions, masks: (B, ...)) their
    batch shard; a plain tensor counts as replicated.  The result takes
    q's shape and placements."""
    q = heads[0]
    mesh = q.device_mesh
    place = tuple(p if p.is_shard() and p.dim in (0, 2) else Replicate()
                  for p in q.placements)
    row_place = tuple(Shard(0) if p.is_shard() and p.dim == 0
                      else Replicate() for p in place)

    def local(t, pl):
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, (Replicate(),) * mesh.ndim,
                                   run_check=False)
        return t.redistribute(mesh, pl).to_local()

    out = fn(*(_ContiguousGrad.apply(local(t, place)) for t in heads),
             *(local(t, row_place) for t in rows)).contiguous()
    return from_shards(out, mesh, place, q.shape)


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
    p = batch_whole(p, x, cfg)
    x, xkv = whole_seq(x), whole_seq(xkv)
    src = x if xkv is None else xkv
    Sk = src.shape[1]
    q = heads_view(x @ p["wq"], B, S, NH, dh)
    k = heads_view(src @ p["wk"], B, Sk, KV, dh)
    v = heads_view(src @ p["wv"], B, Sk, KV, dh)
    if xkv is None:
        if angles is None and cfg.mrope and positions3 is not None:
            angles = mrope_angles(positions3, dh, cfg.rope_theta,
                                  cfg.mrope_sections)
        angles = angles or rope_angles(positions, dh, cfg.rope_theta)
        q = apply_rope(q, positions, cfg.rope_theta, angles=angles)
        k = apply_rope(k, positions, cfg.rope_theta, angles=angles)
    kw = dict(causal=causal, window=cfg.swa_window, q_block=cfg.attn_q_block,
              kv_block=cfg.attn_kv_block, cfg=cfg)

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
            _write_prefix(ck, k_w)
            _write_prefix(cv, v_w)
            _write_prefix(cpos, p_w)
        else:
            # a device-side slot (no host sync), clamped as the reference's
            # dynamic_update_slice clamps its start
            idx = kv_len[:1].long().clamp(0, S_cache - S_w) + torch.arange(
                S_w, device=x.device)
            _write_slots(ck, idx, k_w)
            _write_slots(cv, idx, v_w)
            _write_slots(cpos, idx, p_w)
        out = attention(q, ck, cv, positions, cpos, bias=bias, **kw)
        new_cache = cache
    else:
        pos_k = positions if xkv is None else torch.arange(
            Sk, dtype=torch.int32, device=x.device).expand(B, Sk)
        out = attention(q, k, v, positions, pos_k, **kw)
        new_cache = None
    return heads_view(out, B, S, NH * dh) @ p["wo"], new_cache


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def mlp_block(p: Mapping[str, torch.Tensor], x: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    p = batch_whole(p, x, cfg)
    x = whole_seq(x)
    if cfg.mlp_type == "swiglu":
        return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
    return F.gelu(x @ p["w_in"], approximate="tanh") @ p["w_down"]
