"""Step builders + abstract input specs for every (arch x shape) dry-run
cell: one training step (forward_loss -> backward -> AdamW), one prefill
and one decode step, each on one card or sharded over a DeviceMesh.

Counterpart of ``repro/launch/steps.py``.  ``mesh_cfg``,
``batch_abstract`` and ``input_specs`` describe a dry-run cell as the
reference's do: the step, its abstract inputs (meta tensors: shapes and
dtypes, nothing allocated) and their placements on the mesh.  The
dry-run (``dryrun.py``) turns the abstract inputs into DTensors of fake
shards on a fake process group of 256 or 512 ranks; the same builders
run a real sharded step on gloo or NCCL ranks (``distribute_inputs``).

Shapes (assignment):
  train_4k     seq 4,096   global_batch 256   -> train_step
  prefill_32k  seq 32,768  global_batch 32    -> serve_prefill
  decode_32k   seq 32,768  global_batch 128   -> serve_step (1 new token)
  long_500k    seq 524,288 global_batch 1     -> serve_step, sub-quadratic
                                                 archs only (DESIGN.md §5)
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch.distributed.tensor.experimental import implicit_replication

from ..dtensor import is_dtensor
from ..models import model
from ..models.config import ModelConfig
from ..optim.adamw import AdamWConfig, adamw_init, adamw_update
from ..pytree import leaves, tree_map
from . import sharding as shd
from .mesh import axis_sizes, batch_axes as mesh_batch_axes

SHAPES: Dict[str, Tuple[int, int]] = {
    "train_4k": (4096, 256),
    "prefill_32k": (32768, 32),
    "decode_32k": (32768, 128),
    "long_500k": (524288, 1),
}


def shape_applicable(cfg: ModelConfig, shape: str) -> Tuple[bool, str]:
    if shape == "long_500k" and not cfg.sub_quadratic:
        return False, "pure full-attention arch: long_500k needs sub-quadratic"
    return True, ""


def mesh_cfg(cfg: ModelConfig, mesh, batch: int) -> ModelConfig:
    """Attach distribution hints (batch/SP axes) for this mesh."""
    baxes = mesh_batch_axes(mesh)
    sizes = axis_sizes(mesh)
    dp = 1
    for a in baxes:
        dp *= sizes[a]
    return dataclasses.replace(cfg, batch_axes=tuple(baxes), sp_axis="model",
                               dp_size=dp)


# ---------------------------------------------------------------------------
# step functions
# ---------------------------------------------------------------------------


def on_mesh(mesh):
    """The context a step runs in on ``mesh``: a plain tensor meeting a
    DTensor (positions, masks, rope angles) counts as replicated.  The
    model's constraints (``layers.shard_act``, ``shard_heads``) place
    DTensors on the mesh they carry.  No mesh: nothing."""
    return implicit_replication() if mesh is not None else \
        contextlib.nullcontext()


def placed_grad(p: torch.Tensor) -> torch.Tensor:
    """A parameter's gradient; a DTensor's in its parameter's placements
    (a replicated weight's gradient comes back as a partial sum: this is
    the data-parallel all-reduce)."""
    g = p.grad
    if is_dtensor(g) and g.placements != p.placements:
        g = g.redistribute(p.device_mesh, p.placements)
    return g


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, mesh=None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the loss and its gradients in every parameter, then one
    AdamW update, written into the model's parameters and the state's
    moments.  ``opt_state`` mirrors ``model.param_tree(params)``; the
    metrics are the reference's (``loss``, ``ce``, ``aux``, ``tokens``,
    ``grad_norm`` and, where enabled, ``clip_threshold`` and
    ``compress_scale``), as tensors.  With ``mesh``, the step runs there
    (``on_mesh``) on DTensor parameters, state and batch."""
    def train_step(params: model.Transformer, opt_state, batch):
        with on_mesh(mesh):
            tree = model.param_tree(params)
            params.requires_grad_(True)
            loss, metrics = model.forward_loss(params, batch, cfg)
            loss.backward()
            grads = tree_map(placed_grad, tree)
            for p in leaves(tree):
                p.grad = None
            params.requires_grad_(False)
            _, opt_state, opt_metrics = adamw_update(grads, opt_state, tree,
                                                     opt_cfg)
        out = {"loss": loss.detach(),
               **{k: v.detach() for k, v in metrics.items()}, **opt_metrics}
        return params, opt_state, out
    return train_step


def make_prefill_step(cfg: ModelConfig, cache_len: int, mesh=None):
    """``prefill_step(params, batch) -> (logits, cache)``.  With ``mesh``,
    the cache it fills is made there, placed as the reference's prefill
    cache (``sharding.sharded_cache``; an ssm cache is the scan's final
    states and takes the step's placements)."""
    def prefill_step(params, batch):
        with on_mesh(mesh):
            cache = None
            if mesh is not None and cfg.family != "ssm":
                B, S = batch["tokens"].shape
                enc_len = batch["frames"].shape[1] if cfg.is_encdec else 0
                cache = shd.sharded_cache(cfg, B, max(cache_len, S),
                                          enc_len, mesh)
            return model.prefill(params, batch, cfg, cache_len=cache_len,
                                 cache=cache)
    return prefill_step


def make_decode_step(cfg: ModelConfig, mesh=None):
    def serve_step(params, token, cache, cache_len):
        with on_mesh(mesh):
            return model.decode_step(params, token, cache, cache_len, cfg)
    return serve_step


# ---------------------------------------------------------------------------
# abstract inputs (meta tensors only — never allocated)
# ---------------------------------------------------------------------------


def _abs(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def batch_abstract(cfg: ModelConfig, B: int, S: int,
                   with_labels: bool = True) -> Dict[str, Any]:
    b = {"tokens": _abs((B, S), torch.int32)}
    if with_labels:
        b["labels"] = _abs((B, S), torch.int32)
    if cfg.modality == "vision_stub":
        b["patch_embeds"] = _abs((B, cfg.frontend_len, cfg.d_model),
                                 torch.float32)
    if cfg.is_encdec:
        b["frames"] = _abs((B, max(1, S // cfg.enc_seq_divisor),
                            cfg.d_model), torch.float32)
    return b


def input_specs(arch_cfg: ModelConfig, shape: str, mesh,
                opt_cfg: Optional[AdamWConfig] = None,
                seq_batch: Optional[Tuple[int, int]] = None):
    """Returns (fn, args_abstract, in_placements, out_placements, meta) for
    one dry-run cell: ``fn(*distribute_inputs(args, in_placements, mesh))``
    is the whole contract.  The placements mirror the args' trees (the
    parameters' as ``model.param_tree``); an out placement of None is
    left to the step, and ``fn`` redistributes the others' outputs to
    them, as the reference's out_shardings do.  ``seq_batch`` replaces the
    shape's (seq, global batch) (reduced cells)."""
    S, B = seq_batch or SHAPES[shape]
    cfg = mesh_cfg(arch_cfg, mesh, B)
    opt_cfg = opt_cfg or AdamWConfig(quantile_clip=0.999)

    params_abs = model.abstract_params(cfg)
    tree_abs = model.param_tree(params_abs)
    p_place = shd.placements_tree(mesh, shd.param_shardings(mesh, tree_abs))

    if shape == "train_4k":
        opt_abs = adamw_init(tree_abs)
        o_place = shd.placements_tree(mesh, shd.opt_shardings(mesh, opt_abs, tree_abs))
        batch_abs = batch_abstract(cfg, B, S)
        b_place = shd.placements_tree(mesh, shd.batch_spec(mesh, batch_abs, B))
        fn = make_train_step(cfg, opt_cfg, mesh)
        return (fn, (params_abs, opt_abs, batch_abs),
                (p_place, o_place, b_place), (p_place, o_place, None),
                {"cfg": cfg, "tokens_per_step": B * S, "kind": "train"})

    enc_len = S // cfg.enc_seq_divisor if cfg.is_encdec else 0
    if shape == "prefill_32k":
        batch_abs = batch_abstract(cfg, B, S, with_labels=False)
        b_place = shd.placements_tree(mesh, shd.batch_spec(mesh, batch_abs, B))
        cache_abs = model.init_cache(cfg, B, S, enc_len=enc_len,
                                     device="meta")
        c_place = shd.placements_tree(mesh, shd.cache_shardings(mesh, cache_abs, cfg, B))
        step = make_prefill_step(cfg, cache_len=S, mesh=mesh)

        def fn(params, batch):
            logits, cache = step(params, batch)
            return logits, redistribute_tree(cache, c_place, mesh)
        return (fn, (params_abs, batch_abs), (p_place, b_place),
                (None, c_place),
                {"cfg": cfg, "tokens_per_step": B * S, "kind": "prefill"})

    # decode shapes: one new token against a cache of size S
    cache_abs = model.init_cache(cfg, B, S, enc_len=enc_len, device="meta")
    c_place = shd.placements_tree(mesh, shd.cache_shardings(mesh, cache_abs, cfg, B,
                                                decode=True))
    token_abs = _abs((B, 1), torch.int32)
    clen_abs = _abs((B,), torch.int32)
    baxes = mesh_batch_axes(mesh)
    b_entry = baxes if B % cfg.dp_size == 0 else None
    tok_place = shd.placements((b_entry, None), mesh)
    clen_place = shd.placements((b_entry,), mesh)
    step = make_decode_step(cfg, mesh)

    def fn(params, token, cache, cache_len):
        logits, cache = step(params, token, cache, cache_len)
        return logits, redistribute_tree(cache, c_place, mesh)
    return (fn, (params_abs, token_abs, cache_abs, clen_abs),
            (p_place, tok_place, c_place, clen_place),
            (None, c_place),
            {"cfg": cfg, "tokens_per_step": B, "kind": "decode"})


# ---------------------------------------------------------------------------
# abstract or real inputs -> DTensors
# ---------------------------------------------------------------------------


def redistribute_tree(tree, place_tree, mesh):
    """Each DTensor leaf of ``tree`` redistributed to its placements in
    ``place_tree`` (a tree of the same shape)."""
    def one(t, pl):
        if is_dtensor(t) and tuple(t.placements) != tuple(pl):
            return t.redistribute(mesh, pl)
        return t
    return shd.zip_map(one, tree, place_tree)


def distribute_inputs(args, in_placements, mesh):
    """A cell's inputs as DTensors: the model through
    ``sharding.distribute_params``; every other tensor by its placements,
    a meta one as a zero-filled shard made on each rank (a fake one under
    a FakeTensorMode), a real one through ``distribute_tensor``."""
    from torch.distributed.tensor import distribute_tensor

    def one(t, pl):
        if t.is_meta:
            return shd.sharded_full(t.shape, 0, t.dtype, mesh, pl)
        return distribute_tensor(t, mesh, pl)

    out = []
    for a, pl in zip(args, in_placements):
        if isinstance(a, model.Transformer):
            out.append(shd.distribute_params(a, mesh))
        else:
            out.append(shd.zip_map(one, a, pl))
    return tuple(out)
