"""Model assembly, in PyTorch: parameter init, the weights of a JAX
checkpoint and back, the training loss, prefill and decode with a KV cache,
for the dense, vlm and moe families (every family built on the dense
block).

Counterpart of those branches of ``repro/models/model.py``.
Conventions, as the reference's:

  * weights by the JAX names: ``Transformer.p`` holds ``embed``,
    ``final_norm`` (``final_norm_b``), ``head`` and, for a vision_stub
    config, ``patch_proj``; each ``DenseBlock.p`` one layer's slice of
    ``params["blocks"]`` (``ln1``, ``wq``, ``wk``, ``wv``, ``wo``, ``ln2``,
    ``w_gate``/``w_up`` or ``w_in``, ``w_down``, with ``ln*_b`` for
    LayerNorm configs; a moe layer holds ``router`` and the experts'
    ``we_gate``, ``we_up``, ``we_down`` instead of the MLP, and keeps the
    MLP as Arctic's dense residual);
  * a vision_stub batch may carry ``patch_embeds`` (B, F, D), projected by
    ``patch_proj`` in place of the first F token embeddings, and an M-RoPE
    config rotates by ``positions3`` (3, B, S), the batch's or the
    positions broadcast;
  * matmul weights in ``cfg.param_dtype``, norms in f32;
  * the cache is {"k", "v": (L, B, S, KV, dh), "pos": (L, B, S) int32},
    unwritten slots at position 2^30, and a sliding-window config keeps a
    ring of ``min(cache_len, swa_window)`` slots.  Prefill and decode write
    it in place and return it;
  * the losses ignore label -1, and the cross-entropy runs in sequence
    chunks of ``CE_CHUNK``;
  * a parameter tree (``param_tree``) is a dict of the top weights with
    ``"blocks"`` a list of one dict a layer; ``stacked`` turns such a tree
    (of weights, gradients or optimizer moments) into the JAX package's
    layout, ``"blocks"`` a dict of (L, ...) leaves, and ``unstacked`` back.

The ssm, hybrid and audio families are not ported yet: building or
running one raises ``NotImplementedError``.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from . import layers, moe
from .config import ModelConfig
from ..core.select import as_device_tensor, require_device
from ..pytree import tree_map

CE_CHUNK = 256

_PORTED = ("dense", "vlm", "moe")
_NOT_PORTED = {
    "ssm": "ROADMAP.md Queue 1 item 6: the ssm and hybrid families (ssm.py)",
    "hybrid": "ROADMAP.md Queue 1 item 6: the ssm and hybrid families "
              "(ssm.py)",
    "audio": "ROADMAP.md Queue 1 item 6: the audio family (encoder-decoder "
             "with cross-attention)",
}


def _require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in _PORTED:
        where = _NOT_PORTED.get(cfg.family, "ROADMAP.md Queue 1 item 6")
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported to "
            f"PyTorch yet ({where}); the {', '.join(_PORTED)} families are")


def _pdt(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def _block_shapes(cfg: ModelConfig) -> Dict[str, Tuple[Tuple[int, ...], bool]]:
    """One layer's weights: name -> (shape, in param dtype)."""
    D, NH, KV, dh, F = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head,
                        cfg.d_ff)
    shapes = {"ln1": ((D,), False), "wq": ((D, NH * dh), True),
              "wk": ((D, KV * dh), True), "wv": ((D, KV * dh), True),
              "wo": ((NH * dh, D), True), "ln2": ((D,), False)}
    if cfg.use_layernorm:
        shapes.update(ln1_b=((D,), False), ln2_b=((D,), False))
    if cfg.family == "moe":
        E = cfg.moe_experts
        shapes.update(router=((D, E), False), we_gate=((E, D, F), True),
                      we_up=((E, D, F), True), we_down=((E, F, D), True))
        if not cfg.moe_dense_residual:
            return shapes
    if cfg.mlp_type == "swiglu":
        shapes.update(w_gate=((D, F), True), w_up=((D, F), True))
    else:
        shapes["w_in"] = ((D, F), True)
    shapes["w_down"] = ((F, D), True)
    return shapes


def _top_shapes(cfg: ModelConfig) -> Dict[str, Tuple[Tuple[int, ...], bool]]:
    D, V = cfg.d_model, cfg.vocab
    shapes = {"embed": ((V, D), True), "final_norm": ((D,), False),
              "head": ((D, V), True)}
    if cfg.use_layernorm:
        shapes["final_norm_b"] = ((D,), False)
    if cfg.modality == "vision_stub":
        shapes["patch_proj"] = ((D, D), True)
    return shapes


def _empty(shapes, cfg: ModelConfig, device) -> nn.ParameterDict:
    return nn.ParameterDict({
        name: nn.Parameter(torch.empty(shape, device=device,
                                       dtype=_pdt(cfg) if mm else
                                       torch.float32), requires_grad=False)
        for name, (shape, mm) in shapes.items()})


def block_fn(p: Mapping[str, torch.Tensor], x: torch.Tensor,
             cfg: ModelConfig, *, positions: torch.Tensor,
             positions3: Optional[torch.Tensor] = None,
             cache: Optional[dict] = None,
             kv_len: Optional[torch.Tensor] = None, angles=None,
             bias=None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``_dense_block_fn`` of the reference (no cross-attention): pre-norm
    attention, then a pre-norm MLP, or the routed experts (plus the MLP for
    Arctic's dense residual), each added to the residual stream.  Returns
    (x, the moe layer's load-balance loss, else None).  ``cache`` is this
    layer's and is written in place; ``positions3``, ``angles`` and
    ``bias`` as ``layers.attn_block`` takes them."""
    h, _ = layers.attn_block(p, layers.norm(x, p, cfg, "ln1"), cfg,
                             positions=positions, positions3=positions3,
                             cache=cache, kv_len=kv_len, angles=angles,
                             bias=bias)
    x = x + h
    xn = layers.norm(x, p, cfg, "ln2")
    if cfg.family != "moe":
        return x + layers.mlp_block(p, xn, cfg), None
    y, aux = moe.moe_block(p, xn, cfg)
    if cfg.moe_dense_residual:
        y = y + layers.mlp_block(p, xn, cfg)
    return x + y, aux


class DenseBlock(nn.Module):
    """One transformer layer: ``block_fn`` over its weights, under its own
    config or the one a caller passes (``prefill``, ``decode_step`` and
    ``forward_loss`` pass theirs, as the reference's functions use the
    config they are given)."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.cfg = cfg
        self.p = _empty(_block_shapes(cfg), cfg, device)

    def forward(self, x: torch.Tensor, cfg: Optional[ModelConfig] = None,
                **kw) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        return block_fn(self.p, x, cfg or self.cfg, **kw)


class Transformer(nn.Module):
    """A decoder: embedding (and a vision_stub's patch projection),
    ``n_layers`` ``DenseBlock``s, final norm and an untied output head."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        _require_ported(cfg)
        super().__init__()
        device = require_device(device)
        self.cfg = cfg
        self.p = _empty(_top_shapes(cfg), cfg, device)
        self.blocks = nn.ModuleList(DenseBlock(cfg, device)
                                    for _ in range(cfg.n_layers))

    @property
    def device(self) -> torch.device:
        return self.p["embed"].device


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


@torch.no_grad()
def init_params(cfg: ModelConfig, seed: int = 0, *,
                device="cuda") -> Transformer:
    """Random weights with the reference's distributions and scales, from a
    ``torch.Generator`` on ``device`` seeded with ``seed``, one layer at a
    time: matmul weights and the router normal x 0.02 (``wo``, ``w_down``
    and ``we_down`` x 0.02 / sqrt(2 layers)), norms 1, biases 0.  The
    values are not JAX's (``params_from_numpy`` carries those over)."""
    model = Transformer(cfg, device)
    gen = torch.Generator(device=model.device).manual_seed(int(seed))
    so = 0.02 / (2 * max(1, cfg.n_layers + cfg.enc_layers)) ** 0.5

    def fill(pdict: nn.ParameterDict) -> None:
        for name, w in pdict.items():
            if name.startswith(("ln", "final_norm")):
                w.fill_(0.0 if name.endswith("_b") else 1.0)
                continue
            scale = so if name in ("wo", "w_down", "we_down") else 0.02
            w.copy_(torch.randn(w.shape, generator=gen, device=w.device,
                                dtype=torch.float32) * scale)

    fill(model.p)
    for block in model.blocks:
        fill(block.p)
    return model


@torch.no_grad()
def load_params(params: Transformer, tree: Mapping[str, Any]) -> Transformer:
    """Copy a parameter tree in the JAX package's layout (``tree["blocks"]``
    holds the stacked (L, ...) leaves) into ``params``, bit for bit.  Leaves
    are tensors or numpy arrays; bf16 numpy leaves may be ml_dtypes arrays
    or their uint16 bits."""
    cfg = params.cfg

    def load(dst: torch.Tensor, a) -> None:
        if isinstance(a, np.ndarray) and a.dtype == np.uint16:
            t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        else:
            t = as_device_tensor(a, "cpu")
        if t.shape != dst.shape or t.dtype != dst.dtype:
            raise ValueError(f"leaf {tuple(t.shape)} {t.dtype} does not fit "
                             f"{tuple(dst.shape)} {dst.dtype}")
        dst.copy_(t)

    expect = set(_top_shapes(cfg)) | {"blocks"}
    if set(tree) != expect:
        raise ValueError(f"parameter tree has {sorted(tree)}, expected "
                         f"{sorted(expect)}")
    for name, w in params.p.items():
        load(w, tree[name])
    blocks = tree["blocks"]
    if set(blocks) != set(_block_shapes(cfg)):
        raise ValueError(f"blocks have {sorted(blocks)}, expected "
                         f"{sorted(_block_shapes(cfg))}")
    for i, block in enumerate(params.blocks):
        for name, w in block.p.items():
            load(w, blocks[name][i])
    return params


def params_from_numpy(cfg: ModelConfig, tree: Mapping[str, Any],
                      device="cuda") -> Transformer:
    """The JAX parameter pytree of ``repro.models.model.init_params``
    (dense, vlm or moe family), given as numpy arrays, as a ``Transformer``
    on ``device``, bit for bit.  bf16 leaves may be ml_dtypes arrays or
    their uint16 bits; ``tree["blocks"]`` holds the stacked (L, ...)
    leaves."""
    return load_params(Transformer(cfg, device), tree)


def param_tree(params: Transformer) -> Dict[str, Any]:
    """The model's parameters as a tree: the top weights by name and
    ``"blocks"``, a list of one dict a layer.  The leaves are the model's
    own ``nn.Parameter``s."""
    tree: Dict[str, Any] = dict(params.p.items())
    tree["blocks"] = [dict(block.p.items()) for block in params.blocks]
    return tree


def stacked(tree: Mapping[str, Any], device=None) -> Dict[str, Any]:
    """A tree shaped as ``param_tree`` (weights, gradients or moments) in
    the JAX package's layout: ``"blocks"`` a dict of (L, ...) leaves.  The
    leaves are detached copies, on ``device`` if given (else where they
    are)."""
    def to(t: torch.Tensor, copy: bool = False) -> torch.Tensor:
        return t.detach().to(t.device if device is None else device,
                             copy=copy)

    out = {name: to(t, copy=True) for name, t in tree.items()
           if name != "blocks"}
    layers_ = tree["blocks"]
    out["blocks"] = {name: torch.stack([to(layer[name]) for layer in layers_])
                     for name in layers_[0]}
    return out


def unstacked(tree: Mapping[str, Any]) -> Dict[str, Any]:
    """The inverse of ``stacked``: ``"blocks"`` as a list of one dict a
    layer, whose leaves are views of the stacked ones."""
    out = {name: t for name, t in tree.items() if name != "blocks"}
    blocks = tree["blocks"]
    L = len(next(iter(blocks.values())))
    out["blocks"] = [{name: t[i] for name, t in blocks.items()}
                     for i in range(L)]
    return out


def params_to_numpy(tree) -> Dict[str, Any]:
    """The inverse of ``params_from_numpy``: a ``Transformer``, or a tree
    shaped as its ``param_tree`` (its gradients, say), as numpy arrays in
    the JAX package's stacked layout.  bf16 leaves come as their uint16
    bits."""
    if isinstance(tree, Transformer):
        tree = param_tree(tree)

    def host(t: torch.Tensor) -> np.ndarray:
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()

    return tree_map(host, stacked(tree, device="cpu"))


# ---------------------------------------------------------------------------
# forward (training / scoring)
# ---------------------------------------------------------------------------


# the matmuls without a batch dimension (the projections, the MLP and the
# router), whose outputs ``remat="dots"`` keeps, as JAX's
# ``dots_with_no_batch_dims_saveable``; the attention's and the experts'
# batched products (``bmm``) are recomputed
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    policy = ckpt.CheckpointPolicy
    return policy.MUST_SAVE if op in _DOTS else policy.PREFER_RECOMPUTE


def _remat(block: DenseBlock, cfg: ModelConfig):
    """The block as the backward sees it: ``"none"`` keeps every
    activation; ``"nothing_saveable"`` keeps the block's input and reruns
    its forward in the backward; ``"dots"`` also keeps the outputs of its
    non-batched matmuls."""
    if cfg.remat == "none":
        return block
    if cfg.remat == "nothing_saveable":
        return functools.partial(ckpt.checkpoint, block, use_reentrant=False)
    if cfg.remat == "dots":
        return functools.partial(
            ckpt.checkpoint, block, use_reentrant=False,
            context_fn=functools.partial(
                ckpt.create_selective_checkpoint_contexts, _save_dots))
    raise ValueError(f"unknown remat policy {cfg.remat!r}")


def _run_decoder_train(params: Transformer, x: torch.Tensor,
                       cfg: ModelConfig, positions: torch.Tensor,
                       positions3: Optional[torch.Tensor] = None):
    """Every block in turn under the config's remat policy; returns the
    residual stream and the sum of the layers' load-balance losses (0
    outside the moe family)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for block in params.blocks:
        x, aux_l = _remat(block, cfg)(x, cfg, positions=positions,
                                      positions3=positions3)
        if aux_l is not None:
            aux = aux + aux_l
    return x, aux


def chunked_ce_loss(x: torch.Tensor, head: torch.Tensor,
                    labels: torch.Tensor, chunk: int = CE_CHUNK
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean cross-entropy over labels >= 0, a chunk of ``chunk`` positions
    at a time: S padded to whole chunks with label -1, each chunk's logits
    ``(xb @ head)`` taken to f32, logsumexp - gold.  Returns (loss, the
    int32 count of labels counted)."""
    B, S, _ = x.shape
    nc = -(-S // chunk)
    pad = nc * chunk - S
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad), value=-1)
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.int32, device=x.device)
    for c in range(nc):
        xb = x[:, c * chunk:(c + 1) * chunk]
        lb = labels[:, c * chunk:(c + 1) * chunk]
        logits = (xb @ head).float()
        lse = torch.logsumexp(logits, -1)
        gold = logits.gather(-1, lb.clamp(min=0).long()[..., None])[..., 0]
        valid = lb >= 0
        tot = tot + torch.where(valid, lse - gold, 0.0).sum()
        cnt = cnt + valid.sum(dtype=torch.int32)
    return tot / torch.clamp(cnt, min=1), cnt


def forward_loss(params: Transformer, batch: Mapping[str, torch.Tensor],
                 cfg: ModelConfig) -> Tuple[torch.Tensor, Dict]:
    """Training forward: the mean cross-entropy of ``batch["labels"]``
    (-1 ignored) after ``batch["tokens"]`` (and a vision_stub's
    ``patch_embeds``, a batch's ``positions3``), plus 0.01 x the mean
    layer's load-balance loss for the moe family; and {"ce", "aux",
    "tokens"}.  Differentiable in the model's parameters where they require
    grad."""
    _require_ported(cfg)
    x, positions, positions3 = _embed_inputs(params.p, batch, cfg)
    x, aux = _run_decoder_train(params, x, cfg, positions, positions3)
    x = layers.norm(x, params.p, cfg, "final_norm")
    loss, n_tok = chunked_ce_loss(x, params.p["head"], batch["labels"])
    total = loss
    if cfg.family == "moe":
        total = loss + 0.01 * aux / max(1, cfg.n_layers)
    return total, {"ce": loss, "aux": aux, "tokens": n_tok}


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch_size: int, cache_len: int,
               dtype=None, device="cuda") -> Dict[str, torch.Tensor]:
    """Zeroed K/V (L, B, W, KV, dh) in the param dtype (or ``dtype``) and
    positions (L, B, W) at the "unwritten" sentinel 2^30, where W is
    ``cache_len``, or ``min(cache_len, swa_window)`` for a sliding-window
    config (a ring)."""
    _require_ported(cfg)
    device = require_device(device)
    dt = dtype or _pdt(cfg)
    L, B, KV, dh = cfg.n_layers, batch_size, cfg.n_kv_heads, cfg.d_head
    W = min(cache_len, cfg.swa_window) if cfg.swa_window else cache_len
    return {"k": torch.zeros((L, B, W, KV, dh), dtype=dt, device=device),
            "v": torch.zeros((L, B, W, KV, dh), dtype=dt, device=device),
            "pos": torch.full((L, B, W), layers.UNWRITTEN, dtype=torch.int32,
                              device=device)}


def _layer_cache(cache: Dict[str, torch.Tensor], i: int) -> dict:
    return {"k": cache["k"][i], "v": cache["v"][i], "pos": cache["pos"][i]}


def _embed_inputs(top: Mapping[str, torch.Tensor],
                  batch: Mapping[str, torch.Tensor], cfg: ModelConfig):
    """The input stream, positions 0..S-1 and the M-RoPE positions, from
    the top weights ``top`` (``Transformer.p``): token embeddings (the
    gather's backward adds each position's gradient into its token's row),
    a vision_stub's ``batch["patch_embeds"]`` (B, F, D), cast to the
    embeddings' dtype and projected by ``patch_proj``, in place of the
    first F; ``batch["positions3"]`` (3, B, S), or for an M-RoPE config the
    positions broadcast to 3 streams, else None."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = top["embed"][tokens.long()]
    if cfg.modality == "vision_stub" and "patch_embeds" in batch:
        pe = batch["patch_embeds"].to(x.dtype) @ top["patch_proj"]
        x = torch.cat([pe, x[:, pe.shape[1]:]], dim=1)
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device).expand(B, S)
    positions3 = batch.get("positions3")
    if cfg.mrope and positions3 is None:
        positions3 = positions.expand(3, B, S)
    return x, positions, positions3


def _logits(params: Transformer, x: torch.Tensor, cfg: ModelConfig):
    x = layers.norm(x, params.p, cfg, "final_norm")
    return (x[:, 0] @ params.p["head"]).float()


@torch.no_grad()
def prefill(params: Transformer, batch: Mapping[str, torch.Tensor],
            cfg: ModelConfig,
            cache_len: int = 0) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Process a full prompt ``batch["tokens"]`` (B, S) (with a vision_stub
    config's ``patch_embeds`` and an M-RoPE config's ``positions3``, where
    given): the last position's logits (B, V) f32 and the filled cache.
    ``cache_len`` sizes the cache (at least S; serving passes prompt + new
    tokens)."""
    _require_ported(cfg)
    B, S = batch["tokens"].shape
    cache_len = max(cache_len, S)
    x, positions, positions3 = _embed_inputs(params.p, batch, cfg)
    cache = init_cache(cfg, B, cache_len, device=params.device)
    for i, block in enumerate(params.blocks):
        x, _ = block(x, cfg, positions=positions, positions3=positions3,
                     cache=_layer_cache(cache, i))
    return _logits(params, x[:, -1:], cfg), cache


@torch.no_grad()
def decode_step(params: Transformer, token: torch.Tensor,
                cache: Dict[str, torch.Tensor], cache_len: torch.Tensor,
                cfg: ModelConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step.  token: (B, 1) int; cache_len: (B,) int32 filled
    length (the new token's position).  Writes the token's K/V at slot
    ``cache_len[0]`` (``cache_len % swa_window`` in a ring) in place and
    returns (logits (B, V) f32, the cache)."""
    _require_ported(cfg)
    B = token.shape[0]
    x = params.p["embed"][token.long()]
    positions = cache_len[:, None].to(torch.int32).expand(B, 1)
    write_pos = cache_len
    W = cache["k"].shape[2]
    if cfg.swa_window and W == cfg.swa_window:
        write_pos = cache_len % cfg.swa_window      # ring buffer slot
    # every layer writes the same position at the same slot: the rope
    # angles (M-RoPE's over the position broadcast to 3 streams, as the
    # reference's) and the mask over the written cache serve all of them
    if cfg.mrope:
        angles = layers.mrope_angles(positions.expand(3, B, 1), cfg.d_head,
                                     cfg.rope_theta, cfg.mrope_sections)
    else:
        angles = layers.rope_angles(positions, cfg.d_head, cfg.rope_theta)
    slot = write_pos[:1].long().clamp(0, W - 1)
    pos_k = cache["pos"][0].index_copy(1, slot, positions)
    bias = layers._mask_bias(positions, pos_k, None, True, cfg.swa_window)
    for i, block in enumerate(params.blocks):
        x, _ = block(x, cfg, positions=positions,
                     cache=_layer_cache(cache, i), kv_len=write_pos,
                     angles=angles, bias=bias)
    return _logits(params, x, cfg), cache
