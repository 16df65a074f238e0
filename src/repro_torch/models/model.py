"""Model assembly for serving, in PyTorch: parameter init, the weights of
a JAX checkpoint, prefill and decode with a KV cache, for the dense family.

Counterpart of the dense branches of ``repro/models/model.py``.
Conventions, as the reference's:

  * weights by the JAX names: ``Transformer.p`` holds ``embed``,
    ``final_norm`` (``final_norm_b``) and ``head``; each ``DenseBlock.p``
    one layer's slice of ``params["blocks"]`` (``ln1``, ``wq``, ``wk``,
    ``wv``, ``wo``, ``ln2``, ``w_gate``/``w_up`` or ``w_in``, ``w_down``,
    with ``ln*_b`` for LayerNorm configs);
  * matmul weights in ``cfg.param_dtype``, norms in f32;
  * the cache is {"k", "v": (L, B, S, KV, dh), "pos": (L, B, S) int32},
    unwritten slots at position 2^30, and a sliding-window config keeps a
    ring of ``min(cache_len, swa_window)`` slots.  Prefill and decode write
    it in place and return it.

The moe, vlm, ssm, hybrid and audio families are not ported yet: building
or running one raises ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from . import layers
from .config import ModelConfig
from ..core.select import as_device_tensor, require_device

_NOT_PORTED = {
    "vlm": "ROADMAP.md Queue 1 item 6: the vlm family (apply_mrope, "
           "patch_proj)",
    "moe": "ROADMAP.md Queue 1 item 6: the moe family (moe.py)",
    "ssm": "ROADMAP.md Queue 1 item 6: the ssm and hybrid families (ssm.py)",
    "hybrid": "ROADMAP.md Queue 1 item 6: the ssm and hybrid families "
              "(ssm.py)",
    "audio": "ROADMAP.md Queue 1 item 6: the audio family (encoder-decoder "
             "with cross-attention)",
}


def _require_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        where = _NOT_PORTED.get(cfg.family, "ROADMAP.md Queue 1 item 6")
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported to "
            f"PyTorch yet ({where}); only the dense family is")


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
    return shapes


def _empty(shapes, cfg: ModelConfig, device) -> nn.ParameterDict:
    return nn.ParameterDict({
        name: nn.Parameter(torch.empty(shape, device=device,
                                       dtype=_pdt(cfg) if mm else
                                       torch.float32), requires_grad=False)
        for name, (shape, mm) in shapes.items()})


class DenseBlock(nn.Module):
    """One transformer layer: pre-norm attention, then a pre-norm MLP, each
    added to the residual stream."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.cfg = cfg
        self.p = _empty(_block_shapes(cfg), cfg, device)

    def forward(self, x: torch.Tensor, *, positions: torch.Tensor,
                cache: Optional[dict] = None,
                kv_len: Optional[torch.Tensor] = None,
                angles=None, bias=None) -> torch.Tensor:
        """``_dense_block_fn`` of the reference (no MoE, no
        cross-attention); ``cache`` is this layer's and is written in
        place; ``angles`` and ``bias`` as ``layers.attn_block`` takes
        them."""
        cfg, p = self.cfg, self.p
        h, _ = layers.attn_block(p, layers.norm(x, p, cfg, "ln1"), cfg,
                                 positions=positions, cache=cache,
                                 kv_len=kv_len, angles=angles, bias=bias)
        x = x + h
        return x + layers.mlp_block(p, layers.norm(x, p, cfg, "ln2"), cfg)


class Transformer(nn.Module):
    """A dense decoder: embedding, ``n_layers`` ``DenseBlock``s, final norm
    and an untied output head."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        _require_dense(cfg)
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
    time: matmul weights normal x 0.02 (``wo`` and ``w_down`` x 0.02 /
    sqrt(2 layers)), norms 1, biases 0.  The values are not JAX's
    (``params_from_numpy`` carries those over)."""
    model = Transformer(cfg, device)
    gen = torch.Generator(device=model.device).manual_seed(int(seed))
    so = 0.02 / (2 * max(1, cfg.n_layers + cfg.enc_layers)) ** 0.5

    def fill(pdict: nn.ParameterDict) -> None:
        for name, w in pdict.items():
            if name.startswith(("ln", "final_norm")):
                w.fill_(0.0 if name.endswith("_b") else 1.0)
                continue
            scale = so if name in ("wo", "w_down") else 0.02
            w.copy_(torch.randn(w.shape, generator=gen, device=w.device,
                                dtype=torch.float32) * scale)

    fill(model.p)
    for block in model.blocks:
        fill(block.p)
    return model


@torch.no_grad()
def params_from_numpy(cfg: ModelConfig, tree: Mapping[str, Any],
                      device="cuda") -> Transformer:
    """The JAX parameter pytree of ``repro.models.model.init_params`` (dense
    family), given as numpy arrays, as a ``Transformer`` on ``device``, bit
    for bit.  bf16 leaves may be ml_dtypes arrays or their uint16 bits;
    ``tree["blocks"]`` holds the stacked (L, ...) leaves."""
    model = Transformer(cfg, device)

    def load(dst: torch.Tensor, a) -> None:
        a = np.asarray(a)
        if a.dtype == np.uint16:
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
    for name, w in model.p.items():
        load(w, tree[name])
    blocks = tree["blocks"]
    if set(blocks) != set(_block_shapes(cfg)):
        raise ValueError(f"blocks have {sorted(blocks)}, expected "
                         f"{sorted(_block_shapes(cfg))}")
    for i, block in enumerate(model.blocks):
        for name, w in block.p.items():
            load(w, np.asarray(blocks[name])[i])
    return model


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch_size: int, cache_len: int,
               dtype=None, device="cuda") -> Dict[str, torch.Tensor]:
    """Zeroed K/V (L, B, W, KV, dh) in the param dtype (or ``dtype``) and
    positions (L, B, W) at the "unwritten" sentinel 2^30, where W is
    ``cache_len``, or ``min(cache_len, swa_window)`` for a sliding-window
    config (a ring)."""
    _require_dense(cfg)
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


def _embed_inputs(params: Transformer, batch: Mapping[str, torch.Tensor]):
    """Token embeddings and positions 0..S-1 (text only)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = params.p["embed"][tokens.long()]
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device).expand(B, S)
    return x, positions


def _logits(params: Transformer, x: torch.Tensor, cfg: ModelConfig):
    x = layers.norm(x, params.p, cfg, "final_norm")
    return (x[:, 0] @ params.p["head"]).float()


@torch.no_grad()
def prefill(params: Transformer, batch: Mapping[str, torch.Tensor],
            cfg: ModelConfig,
            cache_len: int = 0) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Process a full prompt ``batch["tokens"]`` (B, S): the last
    position's logits (B, V) f32 and the filled cache.  ``cache_len`` sizes
    the cache (at least S; serving passes prompt + new tokens)."""
    _require_dense(cfg)
    B, S = batch["tokens"].shape
    cache_len = max(cache_len, S)
    x, positions = _embed_inputs(params, batch)
    cache = init_cache(cfg, B, cache_len, device=params.device)
    for i, block in enumerate(params.blocks):
        x = block(x, positions=positions, cache=_layer_cache(cache, i))
    return _logits(params, x[:, -1:], cfg), cache


@torch.no_grad()
def decode_step(params: Transformer, token: torch.Tensor,
                cache: Dict[str, torch.Tensor], cache_len: torch.Tensor,
                cfg: ModelConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step.  token: (B, 1) int; cache_len: (B,) int32 filled
    length (the new token's position).  Writes the token's K/V at slot
    ``cache_len[0]`` (``cache_len % swa_window`` in a ring) in place and
    returns (logits (B, V) f32, the cache)."""
    _require_dense(cfg)
    B = token.shape[0]
    x = params.p["embed"][token.long()]
    positions = cache_len[:, None].to(torch.int32).expand(B, 1)
    write_pos = cache_len
    W = cache["k"].shape[2]
    if cfg.swa_window and W == cfg.swa_window:
        write_pos = cache_len % cfg.swa_window      # ring buffer slot
    # every layer writes the same position at the same slot: the rope
    # angles and the mask over the written cache serve all of them
    angles = layers.rope_angles(positions, cfg.d_head, cfg.rope_theta)
    slot = write_pos[:1].long().clamp(0, W - 1)
    pos_k = cache["pos"][0].index_copy(1, slot, positions)
    bias = layers._mask_bias(positions, pos_k, None, True, cfg.swa_window)
    for i, block in enumerate(params.blocks):
        x = block(x, positions=positions, cache=_layer_cache(cache, i),
                  kv_len=write_pos, angles=angles, bias=bias)
    return _logits(params, x, cfg), cache
