"""Model assembly, in PyTorch: parameter init, the weights of a JAX
checkpoint and back, the training loss, prefill and decode with a cache,
for every family of ``repro/models/model.py``: dense, vlm, moe, ssm,
hybrid and the encoder-decoder (audio).

Counterpart of ``repro/models/model.py``.  Conventions, as the
reference's:

  * weights by the JAX names: ``Transformer.p`` holds ``embed``,
    ``final_norm`` (``final_norm_b``), ``head``, for a vision_stub config
    ``patch_proj`` and for an encoder-decoder ``enc_norm``; each
    ``DenseBlock.p`` one layer's slice of ``params["blocks"]`` (``ln1``,
    ``wq``, ``wk``, ``wv``, ``wo``, ``ln2``, ``w_gate``/``w_up`` or
    ``w_in``, ``w_down``, with ``ln*_b`` for LayerNorm configs; a moe layer
    holds ``router`` and the experts' ``we_gate``, ``we_up``, ``we_down``
    instead of the MLP, and keeps the MLP as Arctic's dense residual);
  * an ssm model (mamba2) is ``n_layers`` ``MambaBlock``s, each ``p`` one
    layer of the reference's ``params["blocks"]`` (``norm``, ``in_proj``,
    ``conv_w``, ``conv_b``, ``A_log``, ``D``, ``dt_bias``, ``out_norm``,
    ``out_proj``); a hybrid model (zamba2) is ``n_layers / every`` groups
    (``Transformer.mamba``) of ``every = hybrid_attn_every``
    ``MambaBlock``s, each group followed by one ``DenseBlock`` whose
    weights all groups share (``Transformer.shared``, the reference's
    ``params["shared"]``);
  * an encoder-decoder (seamless) is ``enc_layers`` ``DenseBlock``s
    (``Transformer.enc_blocks``: non-causal self-attention over the
    batch's ``frames`` (B, Sf, D), then rmsnorm by ``enc_norm``) and
    ``n_layers`` decoder ``DenseBlock``s (``dec_blocks``) that also hold
    the cross-attention's ``ln_c`` (``ln_c_b``), ``wq_c``, ``wk_c``,
    ``wv_c`` and ``wo_c``;
  * a vision_stub batch may carry ``patch_embeds`` (B, F, D), projected by
    ``patch_proj`` in place of the first F token embeddings, and an M-RoPE
    config rotates by ``positions3`` (3, B, S), the batch's or the
    positions broadcast;
  * matmul weights in ``cfg.param_dtype``, norms in f32;
  * the attention cache is {"k", "v": (L, B, S, KV, dh), "pos": (L, B, S)
    int32}, unwritten slots at position 2^30, and a sliding-window config
    keeps a ring of ``min(cache_len, swa_window)`` slots; an ssm cache is
    {"ssm": (L, B, H, hd, N) f32, "conv": (L, B, K - 1, d_inner + 2N)}; a
    hybrid's is {"mamba": that cache at (G, every, ...), "shared": the
    attention cache of G layers}; an encoder-decoder's {"self": the
    attention cache, "cross": {"k", "v": (L, B, Sf, KV, dh)}}, the cross
    K/V of the encoder's output, filled once by prefill.  Prefill returns
    it, and decode writes it in place and returns it;
  * the losses ignore label -1, and the cross-entropy runs in sequence
    chunks of ``CE_CHUNK``;
  * a parameter tree (``param_tree``) is a dict of the top weights with
    ``"blocks"`` a list of one dict a layer (a hybrid's ``"mamba"`` a list
    of G lists of ``every`` dicts, and ``"shared"`` one dict; an
    encoder-decoder's ``"enc_blocks"`` and ``"dec_blocks"``); ``stacked``
    turns such a tree (of weights, gradients or optimizer moments) into the
    JAX package's layout, each list of layers a dict of (L, ...) leaves
    (``"mamba"`` of (G, every, ...) leaves), and ``unstacked`` back.

A family the reference does not name builds a dense model, as the
reference's ``init_params`` does.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from . import layers, moe, ssm
from .config import ModelConfig
from ..core.select import as_device_tensor, require_device
from ..dtensor import is_dtensor
from ..pytree import leaves, paths, tree_map, unflatten

CE_CHUNK = 256

def _pdt(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def _block_shapes(cfg: ModelConfig, cross: bool = False
                  ) -> Dict[str, Tuple[Tuple[int, ...], bool]]:
    """One layer's weights: name -> (shape, in param dtype); ``cross`` adds
    a decoder layer's cross-attention (the ``_c`` leaves)."""
    D, NH, KV, dh, F = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head,
                        cfg.d_ff)
    shapes = {"ln1": ((D,), False), "wq": ((D, NH * dh), True),
              "wk": ((D, KV * dh), True), "wv": ((D, KV * dh), True),
              "wo": ((NH * dh, D), True), "ln2": ((D,), False)}
    if cfg.use_layernorm:
        shapes.update(ln1_b=((D,), False), ln2_b=((D,), False))
    if cross:
        shapes.update(ln_c=((D,), False), wq_c=((D, NH * dh), True),
                      wk_c=((D, KV * dh), True), wv_c=((D, KV * dh), True),
                      wo_c=((NH * dh, D), True))
        if cfg.use_layernorm:
            shapes["ln_c_b"] = ((D,), False)
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


def _mamba_shapes(cfg: ModelConfig
                  ) -> Dict[str, Tuple[Tuple[int, ...], bool]]:
    """One mamba layer's weights: name -> (shape, in param dtype)."""
    D, d_in, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    C = d_in + 2 * N
    return {"norm": ((D,), False), "in_proj": ((D, 2 * d_in + 2 * N + H), True),
            "conv_w": ((cfg.ssm_conv, C), False), "conv_b": ((C,), False),
            "A_log": ((H,), False), "D": ((H,), False),
            "dt_bias": ((H,), False), "out_norm": ((d_in,), False),
            "out_proj": ((d_in, D), True)}


def _top_shapes(cfg: ModelConfig) -> Dict[str, Tuple[Tuple[int, ...], bool]]:
    D, V = cfg.d_model, cfg.vocab
    shapes = {"embed": ((V, D), True), "final_norm": ((D,), False),
              "head": ((D, V), True)}
    if cfg.use_layernorm:
        shapes["final_norm_b"] = ((D,), False)
    if cfg.modality == "vision_stub":
        shapes["patch_proj"] = ((D, D), True)
    if cfg.is_encdec:
        shapes["enc_norm"] = ((D,), False)
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
             bias=None, causal: bool = True,
             enc_out: Optional[torch.Tensor] = None,
             cross: Optional[dict] = None,
             cross_bias: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``_dense_block_fn`` of the reference: pre-norm attention (causal
    unless ``causal=False``, as the encoder runs it); for a decoder layer
    with the cross leaves, pre-norm cross-attention (``_cross_attention``);
    then a pre-norm MLP, or the routed experts (plus the MLP for Arctic's
    dense residual), each added to the residual stream.  Returns (x, the
    moe layer's load-balance loss, else None).  ``cache`` is this layer's
    and is written in place; ``positions3``, ``angles`` and ``bias`` as
    ``layers.attn_block`` takes them; ``enc_out``, ``cross`` and
    ``cross_bias`` as ``_cross_attention`` takes them."""
    # on a mesh each branch's output takes the residual stream's placement
    # before the add (``layers.shard_act``: Megatron-SP's reduce-scatter of
    # its partial sums), whose backward gathers the stream's gradient
    # before the branch's matmuls flatten it (torch 2.11's DTensor cannot
    # flatten a split sequence)
    h, _ = layers.attn_block(p, layers.norm(x, p, cfg, "ln1"), cfg,
                             positions=positions, positions3=positions3,
                             cache=cache, kv_len=kv_len, angles=angles,
                             bias=bias, causal=causal)
    x = x + layers.shard_act(h, cfg)
    if "wq_c" in p:
        x = x + layers.shard_act(_cross_attention(
            p, x, cfg, positions, enc_out, cross, cross_bias), cfg)
    xn = layers.norm(x, p, cfg, "ln2")
    if cfg.family != "moe":
        return x + layers.shard_act(layers.mlp_block(p, xn, cfg), cfg), None
    y, aux = moe.moe_block(p, xn, cfg)
    if cfg.moe_dense_residual:
        y = y + layers.mlp_block(p, xn, cfg)
    return x + layers.shard_act(y, cfg), aux


def _cross_attention(p: Mapping[str, torch.Tensor], x: torch.Tensor,
                     cfg: ModelConfig, positions: torch.Tensor,
                     enc_out: Optional[torch.Tensor], cross: Optional[dict],
                     bias: Optional[torch.Tensor]) -> torch.Tensor:
    """The cross branch of the reference's ``_dense_block_fn``: ``ln_c``,
    then non-causal attention of ``x @ wq_c`` (no rope) over keys at
    positions 0..Sf-1, then ``wo_c``.  The K/V are this layer's ``cross``
    cache ({"k", "v": (B, Sf, KV, dh)}, which prefill fills once) where it
    is given, else ``enc_out @ wk_c`` and ``enc_out @ wv_c``.  ``bias``
    may come precomputed for the cache (all zeros: every frame is
    attendable), as a decode step passes it to every layer."""
    cp = {name[:-2]: w for name, w in p.items() if name.endswith("_c")}
    xn = layers.norm(x, p, cfg, "ln_c")
    if cross is None:
        if enc_out is None:
            raise ValueError("a decoder layer needs the encoder's output or "
                             "its cross cache")
        return layers.attn_block(cp, xn, cfg, positions=positions,
                                 causal=False, xkv=enc_out)[0]
    B, S, _ = x.shape
    NH, dh = cfg.n_heads, cfg.d_head
    q = layers.heads_view(layers.whole_seq(xn) @ cp["wq"], B, S, NH, dh)
    Sf = cross["k"].shape[1]
    pos_k = torch.arange(Sf, dtype=torch.int32, device=x.device).expand(B, Sf)
    o = layers.attention(q, cross["k"], cross["v"], positions, pos_k,
                         causal=False, q_block=cfg.attn_q_block,
                         kv_block=cfg.attn_kv_block, bias=bias, cfg=cfg)
    return layers.heads_view(o, B, S, NH * dh) @ cp["wo"]


class DenseBlock(nn.Module):
    """One transformer layer: ``block_fn`` over its weights, under its own
    config or the one a caller passes (``prefill``, ``decode_step`` and
    ``forward_loss`` pass theirs, as the reference's functions use the
    config they are given)."""

    def __init__(self, cfg: ModelConfig, device, cross: bool = False):
        super().__init__()
        self.cfg = cfg
        self.p = _empty(_block_shapes(cfg, cross), cfg, device)

    def forward(self, x: torch.Tensor, cfg: Optional[ModelConfig] = None,
                **kw) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        return block_fn(self.p, x, cfg or self.cfg, **kw)


class MambaBlock(nn.Module):
    """One mamba layer (the reference's ``_mamba_block_fn``): rmsnorm, then
    the chunked ``ssd_forward``, or with a cache one ``ssd_decode`` step
    (which writes the cache in place), added to the residual stream."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.cfg = cfg
        self.p = _empty(_mamba_shapes(cfg), cfg, device)

    def forward(self, x: torch.Tensor, cfg: Optional[ModelConfig] = None,
                cache: Optional[dict] = None) -> torch.Tensor:
        cfg = cfg or self.cfg
        xn = layers.rmsnorm(x, self.p["norm"])
        if cache is None:
            return x + layers.shard_act(ssm.ssd_forward(self.p, xn, cfg),
                                        cfg)
        return x + layers.shard_act(ssm.ssd_decode(self.p, xn, cfg,
                                                   cache)[0], cfg)


class Transformer(nn.Module):
    """A decoder: embedding (and a vision_stub's patch projection), the
    layers, final norm and an untied output head.  The layers are
    ``blocks``: ``n_layers`` ``DenseBlock``s, or ``MambaBlock``s for the
    ssm family; a hybrid has ``mamba``, G groups of ``hybrid_attn_every``
    ``MambaBlock``s, and the one ``shared`` ``DenseBlock`` that runs after
    each group; an encoder-decoder has ``enc_blocks`` (``enc_layers``
    ``DenseBlock``s) and ``dec_blocks`` (``n_layers``, with the
    cross-attention)."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        device = require_device(device)
        self.cfg = cfg
        self.p = _empty(_top_shapes(cfg), cfg, device)
        if cfg.family == "hybrid":
            every = cfg.hybrid_attn_every
            self.mamba = nn.ModuleList(
                nn.ModuleList(MambaBlock(cfg, device) for _ in range(every))
                for _ in range(cfg.n_layers // every))
            self.shared = DenseBlock(cfg, device)
        elif cfg.is_encdec:
            self.enc_blocks = nn.ModuleList(DenseBlock(cfg, device)
                                            for _ in range(cfg.enc_layers))
            self.dec_blocks = nn.ModuleList(DenseBlock(cfg, device, True)
                                            for _ in range(cfg.n_layers))
        else:
            block = MambaBlock if cfg.family == "ssm" else DenseBlock
            self.blocks = nn.ModuleList(block(cfg, device)
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
    time: matmul weights and the router normal x 0.02 (``wo``, ``wo_c``,
    ``w_down`` and ``we_down`` x 0.02 / sqrt(2 layers), the encoder's
    counted), norms (``enc_norm`` too) 1, biases 0; a mamba layer's
    ``in_proj`` normal x 0.02, ``out_proj`` x 0.02 / sqrt(2
    n_layers), ``conv_w`` x 0.1 (rounded to the param dtype, kept in f32),
    ``conv_b`` and ``A_log`` 0, ``D`` 1, ``dt_bias`` -2.  The values are
    not JAX's (``params_from_numpy`` carries those over)."""
    model = Transformer(cfg, device)
    gen = torch.Generator(device=model.device).manual_seed(int(seed))
    so = 0.02 / (2 * max(1, cfg.n_layers + cfg.enc_layers)) ** 0.5
    mamba_scale = {"in_proj": 0.02, "conv_w": 0.1,
                   "out_proj": 0.02 / (2 * max(1, cfg.n_layers)) ** 0.5}
    mamba_const = {"norm": 1.0, "out_norm": 1.0, "D": 1.0, "conv_b": 0.0,
                   "A_log": 0.0, "dt_bias": -2.0}

    def normal(w: torch.Tensor, scale: float) -> torch.Tensor:
        return torch.randn(w.shape, generator=gen, device=w.device,
                           dtype=torch.float32) * scale

    def fill(pdict: nn.ParameterDict) -> None:
        for name, w in pdict.items():
            if name.startswith(("ln", "final_norm", "enc_norm")):
                w.fill_(0.0 if name.endswith("_b") else 1.0)
                continue
            scale = so if name in ("wo", "wo_c", "w_down", "we_down") else 0.02
            w.copy_(normal(w, scale))

    def fill_mamba(pdict: nn.ParameterDict) -> None:
        for name, w in pdict.items():
            if name in mamba_const:
                w.fill_(mamba_const[name])
            else:
                w.copy_(normal(w, mamba_scale[name]).to(_pdt(cfg)))

    fill(model.p)
    for block in _dense_blocks(model):
        fill(block.p)
    for block in _mamba_blocks(model):
        fill_mamba(block.p)
    return model


def abstract_params(cfg: ModelConfig) -> Transformer:
    """The model on the meta device: every leaf's shape and dtype, nothing
    allocated (the dry-run's parameters)."""
    return Transformer(cfg, device="meta")


def param_dicts(params: Transformer):
    """(path, ``nn.ParameterDict``) of every weight dict of the model, the
    path as ``param_tree`` reaches it: () for the top weights, ("blocks",
    i), ("mamba", g, i), ("shared",), ("enc_blocks", i), ("dec_blocks",
    i)."""
    out = [((), params.p)]
    if params.cfg.family == "hybrid":
        out += [(("mamba", g, i), block.p)
                for g, group in enumerate(params.mamba)
                for i, block in enumerate(group)]
        out.append((("shared",), params.shared.p))
        return out
    names = (("enc_blocks", "dec_blocks") if params.cfg.is_encdec
             else ("blocks",))
    for name in names:
        out += [((name, i), block.p)
                for i, block in enumerate(getattr(params, name))]
    return out


def _dense_blocks(params: Transformer):
    if params.cfg.family == "hybrid":
        return [params.shared]
    if params.cfg.is_encdec:
        return list(params.enc_blocks) + list(params.dec_blocks)
    return [] if params.cfg.family == "ssm" else list(params.blocks)


def _mamba_blocks(params: Transformer):
    if params.cfg.family == "hybrid":
        return [block for group in params.mamba for block in group]
    return list(params.blocks) if params.cfg.family == "ssm" else []


# the tree's lists of layers (one dict a layer)
_LAYER_LISTS = ("blocks", "enc_blocks", "dec_blocks")


@torch.no_grad()
def load_params(params: Transformer, tree: Mapping[str, Any]) -> Transformer:
    """Copy a parameter tree in the JAX package's layout (``tree["blocks"]``,
    or an encoder-decoder's ``tree["enc_blocks"]`` and
    ``tree["dec_blocks"]``, holds the stacked (L, ...) leaves; a hybrid's
    ``tree["mamba"]`` the (G, every, ...) leaves and ``tree["shared"]`` one
    block's) into ``params``, bit for bit.  Leaves are tensors or numpy
    arrays; bf16 numpy leaves may be ml_dtypes arrays or their uint16
    bits."""
    def load(dst: torch.Tensor, a) -> None:
        if isinstance(a, np.ndarray) and a.dtype == np.uint16:
            t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        else:
            t = as_device_tensor(a, "cpu")
        if t.shape != dst.shape or t.dtype != dst.dtype:
            raise ValueError(f"leaf {tuple(t.shape)} {t.dtype} does not fit "
                             f"{tuple(dst.shape)} {dst.dtype}")
        dst.copy_(t)

    want = param_tree(params)
    if set(tree) != set(want):
        raise ValueError(f"parameter tree has {sorted(tree)}, expected "
                         f"{sorted(want)}")
    got = unstacked(tree)
    if paths(got) != paths(want):
        raise ValueError(f"the layers' leaves {paths(got)[:4]}... do not "
                         f"match the model's {paths(want)[:4]}...")
    for dst, a in zip(leaves(want), leaves(got)):
        load(dst, a)
    return params


def params_from_numpy(cfg: ModelConfig, tree: Mapping[str, Any],
                      device="cuda") -> Transformer:
    """The JAX parameter pytree of ``repro.models.model.init_params`` (any
    family), given as numpy arrays, as a ``Transformer`` on ``device``, bit
    for bit.  bf16 leaves may be ml_dtypes arrays or their uint16 bits."""
    return load_params(Transformer(cfg, device), tree)


def param_tree(params: Transformer) -> Dict[str, Any]:
    """The model's parameters as a tree: the top weights by name and
    ``"blocks"``, a list of one dict a layer (a hybrid: ``"mamba"``, a
    list of one list a group of one dict a layer, and ``"shared"``, one
    dict; an encoder-decoder: ``"enc_blocks"`` and ``"dec_blocks"``).  The
    leaves are the model's own ``nn.Parameter``s."""
    tree: Dict[str, Any] = dict(params.p.items())
    if params.cfg.family == "hybrid":
        tree["mamba"] = [[dict(block.p.items()) for block in group]
                         for group in params.mamba]
        tree["shared"] = dict(params.shared.p.items())
    elif params.cfg.is_encdec:
        tree["enc_blocks"] = [dict(b.p.items()) for b in params.enc_blocks]
        tree["dec_blocks"] = [dict(b.p.items()) for b in params.dec_blocks]
    else:
        tree["blocks"] = [dict(block.p.items()) for block in params.blocks]
    return tree


def stacked(tree: Mapping[str, Any], device=None) -> Dict[str, Any]:
    """A tree shaped as ``param_tree`` (weights, gradients or moments) in
    the JAX package's layout: ``"blocks"`` (``"enc_blocks"``,
    ``"dec_blocks"``) a dict of (L, ...) leaves, a hybrid's ``"mamba"`` of
    (G, every, ...) leaves.  The leaves are detached copies, on ``device``
    if given (else where they are)."""
    def to(t: torch.Tensor, copy: bool = False) -> torch.Tensor:
        return t.detach().to(t.device if device is None else device,
                             copy=copy)

    def stack(layers_: list) -> Dict[str, torch.Tensor]:
        if isinstance(layers_[0], list):                   # groups of layers
            groups = [stack(group) for group in layers_]
            return {name: torch.stack([g[name] for g in groups])
                    for name in groups[0]}
        return {name: torch.stack([to(layer[name]) for layer in layers_])
                for name in layers_[0]}

    out = {}
    for name, t in tree.items():
        if name in _LAYER_LISTS or name == "mamba":
            out[name] = stack(t)
        elif name == "shared":
            out[name] = {k: to(v, copy=True) for k, v in t.items()}
        else:
            out[name] = to(t, copy=True)
    return out


def unstacked(tree: Mapping[str, Any]) -> Dict[str, Any]:
    """The inverse of ``stacked``: ``"blocks"`` (``"enc_blocks"``,
    ``"dec_blocks"``) as a list of one dict a layer (``"mamba"`` a list of
    G lists), whose leaves are views of the stacked ones."""
    out = {}
    for name, t in tree.items():
        if name in _LAYER_LISTS:
            L = len(next(iter(t.values())))
            out[name] = [{k: v[i] for k, v in t.items()} for i in range(L)]
        elif name == "mamba":
            G, every = next(iter(t.values())).shape[:2]
            out[name] = [[{k: v[g, i] for k, v in t.items()}
                          for i in range(every)] for g in range(G)]
        else:
            out[name] = t
    return out


def by_stacked_leaf(tree: Mapping[str, Any], values) -> Dict[str, list]:
    """``values``, one for each leaf of ``tree`` (shaped as ``param_tree``,
    in ``leaves`` order), grouped by the leaf of the JAX package's layout
    (``stacked``) that holds it, keyed by that leaf's path:
    {"['blocks']['wq']": [layer 0's, layer 1's, ...], "['embed']":
    [its one], ...}."""
    one = unflatten(tree, [torch.tensor(float(v), dtype=torch.float64)
                           for v in values])
    out = stacked(one)
    return {p: t.flatten().tolist() for p, t in zip(paths(out), leaves(out))}


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


def _remat(block: nn.Module, cfg: ModelConfig):
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


def _run_encoder(params: Transformer, frames: torch.Tensor,
                 cfg: ModelConfig, remat: bool) -> torch.Tensor:
    """The encoder over ``frames`` (B, Sf, D), cast to the param dtype: each
    of ``enc_blocks`` with non-causal, rotated self-attention over
    positions 0..Sf-1 (under the config's remat policy where ``remat``),
    then rmsnorm by ``enc_norm`` (rmsnorm for a LayerNorm config too, as
    the reference's ``_run_encoder``)."""
    B, Sf, _ = frames.shape
    x = layers.shard_act(frames.to(_pdt(cfg)), cfg)
    positions = torch.arange(Sf, dtype=torch.int32,
                             device=x.device).expand(B, Sf)
    for block in params.enc_blocks:
        run = _remat(block, cfg) if remat else block
        x, _ = run(x, cfg, positions=positions, causal=False)
        x = layers.shard_act(x, cfg)
    return layers.rmsnorm(x, params.p["enc_norm"])


def _run_decoder_train(params: Transformer, x: torch.Tensor,
                       cfg: ModelConfig, positions: torch.Tensor,
                       positions3: Optional[torch.Tensor] = None,
                       enc_out: Optional[torch.Tensor] = None):
    """Every block in turn under the config's remat policy (a hybrid's
    shared block after each group, its gradient summed over the groups; an
    encoder-decoder's ``dec_blocks``, each attending over ``enc_out``);
    returns the residual stream and the sum of the layers' load-balance
    losses (0 outside the moe family)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    shard = functools.partial(layers.shard_act, cfg=cfg)
    x = shard(x)
    if cfg.is_encdec:
        for block in params.dec_blocks:
            x, _ = _remat(block, cfg)(x, cfg, positions=positions,
                                      enc_out=enc_out)
            x = shard(x)
        return x, aux
    if cfg.family == "ssm":
        for block in params.blocks:
            x = shard(_remat(block, cfg)(x, cfg))
        return x, aux
    if cfg.family == "hybrid":
        for group in params.mamba:
            for block in group:
                x = shard(_remat(block, cfg)(x, cfg))
            x, _ = _remat(params.shared, cfg)(x, cfg, positions=positions,
                                              positions3=positions3)
            x = shard(x)
        return x, aux
    for block in params.blocks:
        x, aux_l = _remat(block, cfg)(x, cfg, positions=positions,
                                      positions3=positions3)
        x = shard(x)
        if aux_l is not None:
            aux = aux + aux_l
    return x, aux


def _logsumexp(logits: torch.Tensor) -> torch.Tensor:
    """logsumexp over the last dim.  A vocab-sharded DTensor row (the
    op has no sharding rule for it, and would gather the logits whole)
    takes the max, then the sum of exps, each a small partial
    reduction."""
    if not is_dtensor(logits):
        return torch.logsumexp(logits, -1)
    m = layers.gather_dims(logits.detach().amax(-1, keepdim=True))
    return (m + torch.log(layers.gather_dims(
        torch.exp(logits - m).sum(-1, keepdim=True))))[..., 0]


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
    # on a mesh: the head's d_model gathered once (FSDP), its vocab left
    # split, and each chunk's positions whole, so that the logits come out
    # split by batch and vocab (not a partial sum of the whole logits)
    head = layers.gather_dims(head, (0,))
    vocab = torch.arange(head.shape[-1], device=x.device)
    for c in range(nc):
        xb = layers.whole_seq(x[:, c * chunk:(c + 1) * chunk])
        lb = labels[:, c * chunk:(c + 1) * chunk]
        logits = (xb @ head).float()
        lse = _logsumexp(logits)
        # the gold logit as a masked sum over the vocabulary, exact (one
        # term is not zero); on a vocab-split DTensor each rank sums its
        # own columns, then the partial sums are reduced (``gather``'s
        # backward would build the whole chunk's logits on every rank)
        hit = vocab == lb.clamp(min=0).long()[..., None]
        gold = layers.gather_dims(torch.where(hit, logits, 0.0).sum(-1))
        valid = lb >= 0
        tot = tot + torch.where(valid, lse - gold, 0.0).sum()
        cnt = cnt + valid.sum(dtype=torch.int32)
    return tot / torch.clamp(cnt, min=1), cnt


def forward_loss(params: Transformer, batch: Mapping[str, torch.Tensor],
                 cfg: ModelConfig) -> Tuple[torch.Tensor, Dict]:
    """Training forward: the mean cross-entropy of ``batch["labels"]``
    (-1 ignored) after ``batch["tokens"]`` (and a vision_stub's
    ``patch_embeds``, a batch's ``positions3``, an encoder-decoder's
    ``frames``), plus 0.01 x the mean layer's load-balance loss for the moe
    family; and {"ce", "aux", "tokens"}.  Differentiable in the model's
    parameters where they require grad."""
    enc_out = (_run_encoder(params, batch["frames"], cfg, remat=True)
               if cfg.is_encdec else None)
    x, positions, positions3 = _embed_inputs(params.p, batch, cfg)
    x, aux = _run_decoder_train(params, x, cfg, positions, positions3,
                                enc_out)
    x = layers.norm(x, params.p, cfg, "final_norm")
    loss, n_tok = chunked_ce_loss(x, params.p["head"], batch["labels"])
    total = loss
    if cfg.family == "moe":
        total = loss + 0.01 * aux / max(1, cfg.n_layers)
    return total, {"ce": loss, "aux": aux, "tokens": n_tok}


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------


def _attn_cache(L: int, B: int, W: int, cfg: ModelConfig, dt,
                device) -> Dict[str, torch.Tensor]:
    KV, dh = cfg.n_kv_heads, cfg.d_head
    return {"k": torch.zeros((L, B, W, KV, dh), dtype=dt, device=device),
            "v": torch.zeros((L, B, W, KV, dh), dtype=dt, device=device),
            "pos": torch.full((L, B, W), layers.UNWRITTEN, dtype=torch.int32,
                              device=device)}


def _ssm_cache(lead: Tuple[int, ...], B: int, cfg: ModelConfig, dt,
               device) -> Dict[str, torch.Tensor]:
    return {"ssm": torch.zeros((*lead, B, cfg.ssm_heads, cfg.ssm_head_dim,
                                cfg.ssm_state), dtype=torch.float32,
                               device=device),
            "conv": torch.zeros((*lead, B, cfg.ssm_conv - 1,
                                 cfg.d_inner + 2 * cfg.ssm_state), dtype=dt,
                                device=device)}


def init_cache(cfg: ModelConfig, batch_size: int, cache_len: int,
               enc_len: int = 0, dtype=None, device="cuda") -> Dict:
    """Zeroed K/V (L, B, W, KV, dh) in the param dtype (or ``dtype``) and
    positions (L, B, W) at the "unwritten" sentinel 2^30, where W is
    ``cache_len``, or ``min(cache_len, swa_window)`` for a sliding-window
    config (a ring).  An ssm config: zeroed {"ssm": (L, B, H, hd, N) f32,
    "conv": (L, B, K - 1, d_inner + 2N)}; a hybrid: {"mamba": those at (G,
    every, ...), "shared": K/V and positions of G layers over
    ``cache_len``}; an encoder-decoder: {"self": that attention cache,
    "cross": zeroed K/V (L, B, ``enc_len``, KV, dh)}."""
    device = require_device(device)
    dt = dtype or _pdt(cfg)
    B = batch_size
    if cfg.family == "ssm":
        return _ssm_cache((cfg.n_layers,), B, cfg, dt, device)
    if cfg.family == "hybrid":
        every = cfg.hybrid_attn_every
        G = cfg.n_layers // every
        return {"mamba": _ssm_cache((G, every), B, cfg, dt, device),
                "shared": _attn_cache(G, B, cache_len, cfg, dt, device)}
    W = min(cache_len, cfg.swa_window) if cfg.swa_window else cache_len
    if cfg.is_encdec:
        cross = _attn_cache(cfg.n_layers, B, enc_len, cfg, dt, device)
        del cross["pos"]
        return {"self": _attn_cache(cfg.n_layers, B, W, cfg, dt, device),
                "cross": cross}
    return _attn_cache(cfg.n_layers, B, W, cfg, dt, device)


def _layer_cache(cache: Dict[str, torch.Tensor], *i) -> dict:
    """One layer's slices (views) of a stacked cache."""
    return {name: t[i] for name, t in cache.items()}


def _embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The rows of ``table`` at ``tokens``, through ``F.embedding``: its
    backward adds a token's occurrences in f32 on the card and rounds
    once (an index's backward, ``index_put_``, rounds to the table's
    dtype at every occurrence), and its sharding rule covers a DTensor
    table, whose vocabulary is gathered first (its d_model stays split;
    the vocab-split embedding's masked partial sums fail with split
    tokens)."""
    return torch.nn.functional.embedding(tokens.long(),
                                         layers.gather_dims(table, (0,)))


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
    x = _embed(top["embed"], tokens)
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


def _prefill_mamba(block: MambaBlock, x: torch.Tensor, cfg: ModelConfig):
    """One mamba layer over the prompt: (x, (its ssm state, its conv
    state)) from the same chunk scan."""
    y, state = ssm.ssd_forward(block.p, layers.rmsnorm(x, block.p["norm"]),
                               cfg, return_state=True)
    return x + layers.shard_act(y, cfg), state


def _stack_states(states: list) -> Dict[str, torch.Tensor]:
    return {"ssm": torch.stack([s for s, _ in states]),
            "conv": torch.stack([c for _, c in states])}


@torch.no_grad()
def prefill(params: Transformer, batch: Mapping[str, torch.Tensor],
            cfg: ModelConfig, cache_len: int = 0,
            cache: Optional[Dict] = None) -> Tuple[torch.Tensor, Dict]:
    """Process a full prompt ``batch["tokens"]`` (B, S) (with a vision_stub
    config's ``patch_embeds``, an M-RoPE config's ``positions3`` where
    given, and an encoder-decoder's ``frames`` (B, Sf, D)): the last
    position's logits (B, V) f32 and the filled cache.  ``cache_len`` sizes
    the attention cache (at least S; serving passes prompt + new tokens);
    an ssm cache takes the scan's final states and ignores it, as the
    reference's does.  An encoder-decoder runs the encoder once, and each
    decoder layer fills its cross cache with ``enc_out @ wk_c`` and
    ``enc_out @ wv_c`` (in the cache's dtype), then attends over it.
    ``cache``, where given, is the empty cache to fill in place of
    ``init_cache``'s (a sharded step passes its DTensors)."""
    B, S = batch["tokens"].shape
    cache_len = max(cache_len, S)
    if cfg.is_encdec:
        return _prefill_encdec(params, batch, cfg, cache_len, cache)
    x, positions, positions3 = _embed_inputs(params.p, batch, cfg)
    shard = functools.partial(layers.shard_act, cfg=cfg)
    x = shard(x)
    if cfg.family == "ssm":
        states = []
        for block in params.blocks:
            x, state = _prefill_mamba(block, x, cfg)
            x = shard(x)
            states.append(state)
        return _logits(params, x[:, -1:], cfg), _stack_states(states)
    if cache is None:
        cache = init_cache(cfg, B, cache_len, device=params.device)
    if cfg.family == "hybrid":
        groups = []
        for g, group in enumerate(params.mamba):
            states = []
            for block in group:
                x, state = _prefill_mamba(block, x, cfg)
                x = shard(x)
                states.append(state)
            groups.append(_stack_states(states))
            x, _ = params.shared(x, cfg, positions=positions,
                                 positions3=positions3,
                                 cache=_layer_cache(cache["shared"], g))
            x = shard(x)
        cache["mamba"] = {name: torch.stack([s[name] for s in groups])
                          for name in ("ssm", "conv")}
        return _logits(params, x[:, -1:], cfg), cache
    for i, block in enumerate(params.blocks):
        x, _ = block(x, cfg, positions=positions, positions3=positions3,
                     cache=_layer_cache(cache, i))
        x = shard(x)
    return _logits(params, x[:, -1:], cfg), cache


def _prefill_encdec(params: Transformer, batch: Mapping[str, torch.Tensor],
                    cfg: ModelConfig, cache_len: int, cache: Optional[Dict]):
    # the encoder's output whole along its sequence, as ``attn_block``
    # takes a projection's input: the cross K/V's reshape would otherwise
    # merge a split sequence
    enc_out = layers.whole_seq(_run_encoder(params, batch["frames"], cfg,
                                            remat=False))
    x, positions, _ = _embed_inputs(params.p, batch, cfg)
    x = layers.shard_act(x, cfg)
    B, Sf = enc_out.shape[:2]
    KV, dh = cfg.n_kv_heads, cfg.d_head
    if cache is None:
        cache = init_cache(cfg, B, cache_len, enc_len=Sf,
                           device=params.device)
    for i, block in enumerate(params.dec_blocks):
        cross = _layer_cache(cache["cross"], i)
        cross["k"].copy_(layers.heads_view(enc_out @ block.p["wk_c"], B, Sf,
                                           KV, dh))
        cross["v"].copy_(layers.heads_view(enc_out @ block.p["wv_c"], B, Sf,
                                           KV, dh))
        x, _ = block(x, cfg, positions=positions,
                     cache=_layer_cache(cache["self"], i), cross=cross)
        x = layers.shard_act(x, cfg)
    return _logits(params, x[:, -1:], cfg), cache


def _decode_attention(cfg: ModelConfig, cache: Dict[str, torch.Tensor],
                      cache_len: torch.Tensor, positions: torch.Tensor):
    """(write slot, rope angles, mask bias) of a decode step's attention
    layers.  Every layer writes the same position at the same slot, so the
    angles (M-RoPE's over the position broadcast to 3 streams, as the
    reference's) and the mask over the written cache serve all of them."""
    B = positions.shape[0]
    write_pos = cache_len
    W = cache["k"].shape[2]
    if cfg.swa_window and W == cfg.swa_window:
        write_pos = cache_len % cfg.swa_window      # ring buffer slot
    if cfg.mrope:
        angles = layers.mrope_angles(positions.expand(3, B, 1), cfg.d_head,
                                     cfg.rope_theta, cfg.mrope_sections)
    else:
        angles = layers.rope_angles(positions, cfg.d_head, cfg.rope_theta)
    slot = write_pos[:1].long().clamp(0, W - 1)
    pos_k = cache["pos"][0].clone()
    layers._write_slots(pos_k, slot, positions)
    bias = layers._mask_bias(positions, pos_k, None, True, cfg.swa_window)
    return write_pos, angles, bias


@torch.no_grad()
def decode_step(params: Transformer, token: torch.Tensor, cache: Dict,
                cache_len: torch.Tensor,
                cfg: ModelConfig) -> Tuple[torch.Tensor, Dict]:
    """One decode step.  token: (B, 1) int; cache_len: (B,) int32 filled
    length (the new token's position).  Writes the token's K/V at slot
    ``cache_len[0]`` (``cache_len % swa_window`` in a ring), and a mamba
    layer's state and conv ring, in place, with no host sync; returns
    (logits (B, V) f32, the cache).  An encoder-decoder's layers also
    attend over their cross cache, under one all-zero mask bias made on
    the device for every layer."""
    B = token.shape[0]
    x = _embed(params.p["embed"], token)
    positions = cache_len[:, None].to(torch.int32).expand(B, 1)
    if cfg.family == "ssm":
        for i, block in enumerate(params.blocks):
            x = block(x, cfg, cache=_layer_cache(cache, i))
        return _logits(params, x, cfg), cache
    attn = cache
    if cfg.family == "hybrid":
        attn = cache["shared"]
    elif cfg.is_encdec:
        attn = cache["self"]
    write_pos, angles, bias = _decode_attention(cfg, attn, cache_len,
                                                positions)
    if cfg.is_encdec:
        cross = cache["cross"]
        cross_bias = torch.zeros((B, 1, cross["k"].shape[2]),
                                 dtype=torch.float32, device=x.device)
        for i, block in enumerate(params.dec_blocks):
            x, _ = block(x, cfg, positions=positions,
                         cache=_layer_cache(attn, i), kv_len=write_pos,
                         angles=angles, bias=bias,
                         cross=_layer_cache(cross, i), cross_bias=cross_bias)
        return _logits(params, x, cfg), cache
    if cfg.family == "hybrid":
        for g, group in enumerate(params.mamba):
            for i, block in enumerate(group):
                x = block(x, cfg, cache=_layer_cache(cache["mamba"], g, i))
            x, _ = params.shared(x, cfg, positions=positions,
                                 cache=_layer_cache(attn, g),
                                 kv_len=write_pos, angles=angles, bias=bias)
        return _logits(params, x, cfg), cache
    for i, block in enumerate(params.blocks):
        x, _ = block(x, cfg, positions=positions,
                     cache=_layer_cache(cache, i), kv_len=write_pos,
                     angles=angles, bias=bias)
    return _logits(params, x, cfg), cache
