"""Sharding rules: parameter/optimizer/batch/cache specs for the production
mesh, and the DTensor placements they give.

Counterpart of ``repro/launch/sharding.py``.  A spec is a tuple with one
entry a tensor dimension: None (replicated), an axis name, or a tuple of
axis names (the dimension split over all of them, the first the major
one) — the entries of the reference's ``PartitionSpec``.

Conventions (MaxText-style):
  "data"  — batch + FSDP axis: parameters and optimizer state shard their
            d_model-sized dim here (ZeRO); activations shard batch here.
  "model" — TP axis: heads*dh / d_ff / experts / vocab / ssm d_inner.
  "pod"   — the inter-node axis: pure data parallelism + hierarchical
            reductions.

Rules are trailing-dim patterns keyed by parameter leaf name.  The port's
parameter tree keeps one dict a layer where the reference stacks the
layers, so a leaf's spec here is the reference's without the leading
Nones of the layer axes.  Divisibility: all trailing dims in the 10
assigned configs divide 16 on their sharded axes except some vocabs
(50280, 256206), which stay replicated on that dim.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import torch
from torch import nn

from ..dtensor import from_shards, placements, shard_range
from ..models.config import ModelConfig
from ..optim.adamw import AdamWState
from .mesh import axis_sizes, batch_axes

__all__ = ["Spec", "param_spec", "param_shardings", "opt_shardings", "batch_spec",
           "cache_shardings", "placements", "local_shape", "sharded_full",
           "sharded_cache", "distribute_params", "map_with_path", "zip_map",
           "placements_tree"]

FSDP = "data"
TP = "model"

# trailing-dims spec per leaf name (None entries replicate)
_TRAILING: Dict[str, Tuple] = {
    "embed": (TP, FSDP),
    "head": (FSDP, TP),
    "patch_proj": (None, TP),
    # attention / dense mlp / mamba projections
    "wq": (FSDP, TP), "wk": (FSDP, TP), "wv": (FSDP, TP),
    "wq_c": (FSDP, TP), "wk_c": (FSDP, TP), "wv_c": (FSDP, TP),
    "w_gate": (FSDP, TP), "w_up": (FSDP, TP), "w_in": (FSDP, TP),
    "in_proj": (FSDP, TP),
    "wo": (TP, FSDP), "wo_c": (TP, FSDP), "w_down": (TP, FSDP),
    "out_proj": (TP, FSDP),
    # MoE (expert-parallel over TP)
    "router": (FSDP, None),
    "we_gate": (TP, FSDP, None), "we_up": (TP, FSDP, None),
    "we_down": (TP, None, FSDP),
    # mamba small tensors
    "conv_w": (None, TP), "conv_b": (TP,), "out_norm": (TP,),
    "A_log": (None,), "D": (None,), "dt_bias": (None,),
}


class Spec(tuple):
    """One entry a tensor dimension (None, an axis name or a tuple of
    them; a tuple of one name is that name, as ``PartitionSpec`` has
    it); a leaf of a tree of specs, never a node."""

    def __new__(cls, entries=()):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self):
        return f"Spec{tuple.__repr__(self)}"


def map_with_path(fn, tree, path: Tuple = ()):
    """``fn(path, leaf)`` over a tree of dicts, lists and named tuples; a
    path holds the dict keys, list indices and field names down to the
    leaf.  A ``Spec`` is a leaf."""
    if isinstance(tree, Spec):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_with_path(fn, getattr(tree, f), path + (f,))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def zip_map(fn, tree, other):
    """``fn(leaf, other_leaf)`` over two trees of the same shape (``other``
    may hold tuples as its leaves, as a tree of specs or placements
    does)."""
    if isinstance(tree, dict):
        return {k: zip_map(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(zip_map(fn, getattr(tree, f), getattr(other, f))
                            for f in tree._fields))
    if isinstance(tree, list):
        return [zip_map(fn, v, o) for v, o in zip(tree, other)]
    return fn(tree, other)


def param_spec(path: Sequence, leaf, mesh) -> Tuple:
    name = next((e for e in reversed(path) if isinstance(e, str)), None)
    rule = _TRAILING.get(name)
    if rule is None:
        return Spec()                   # norms, biases: replicated
    ndim = len(leaf.shape)
    pad = ndim - len(rule)
    if pad < 0:                         # unstacked variant (shared block)
        rule = rule[-ndim:]
        pad = 0
    spec = list((None,) * pad + tuple(rule))
    # the argument shardings require exact divisibility: drop axes that
    # don't divide (e.g. vocab 50280 or 256206 over 16 — those dims stay
    # replicated, the matmul output spec still distributes the compute)
    sizes = axis_sizes(mesh)
    for i, ax in enumerate(spec):
        if ax is None:
            continue
        if leaf.shape[i] % sizes[ax] != 0:
            spec[i] = None
    return Spec(spec)


def param_shardings(mesh, params_tree) -> Any:
    return map_with_path(lambda path, leaf: param_spec(path, leaf, mesh),
                         params_tree)


def opt_shardings(mesh, opt_state_tree: AdamWState, params_tree) -> Any:
    """Optimizer m/v mirror parameter shardings; step is replicated."""
    p_sh = param_shardings(mesh, params_tree)
    return type(opt_state_tree)(step=Spec(), m=p_sh, v=p_sh)


def _batch_split(mesh, batch_size: int):
    baxes = batch_axes(mesh)
    sizes = axis_sizes(mesh)
    nb = 1
    for a in baxes:
        nb *= sizes[a]
    return baxes, nb, batch_size % nb == 0


def batch_spec(mesh, batch_tree, batch_size: int) -> Any:
    """Batch dim over ("pod","data") when divisible; otherwise (long_500k
    B=1) the *sequence* dim shards there instead."""
    baxes, nb, shard_batch = _batch_split(mesh, batch_size)

    def spec(path, leaf):
        nd = len(leaf.shape)
        if nd == 1:
            return Spec((baxes if shard_batch else None,))
        if shard_batch:
            return Spec((baxes, *(None,) * (nd - 1)))
        if nd >= 2 and leaf.shape[1] % nb == 0:
            return Spec((None, baxes, *(None,) * (nd - 2)))
        return Spec((None,) * nd)

    return map_with_path(spec, batch_tree)


def cache_shardings(mesh, cache_tree, cfg: ModelConfig, batch_size: int,
                    decode: bool = False) -> Any:
    """KV caches: (L, B, S, KV, dh) -> batch over ("pod","data") when it
    divides, else sequence.

    Within a batch shard: prefill caches shard dh over "model" (the cache is
    written blockwise along seq, so a seq-sharded prefill cache would reshard
    per kv-block); decode caches shard SEQ over "model" (flash-decoding: the
    one-token attention reduces over seq with small partial-softmax sums,
    and the per-step write touches one shard).
    SSM states: (L, B, H, hd, N) -> batch, H over "model"."""
    baxes, nb, shard_batch = _batch_split(mesh, batch_size)
    tp = axis_sizes(mesh)[TP]
    b = baxes if shard_batch else None

    def rule(path, leaf):
        names = [e for e in path if isinstance(e, str)]
        leaf_name = names[-1] if names else ""
        shape = leaf.shape
        nd = len(shape)
        if leaf_name == "pos":          # (L, B, S)
            if decode and shape[2] % tp == 0:
                return (None, b, TP)
            return (None, b, None)
        if leaf_name in ("k", "v"):     # (L, B, S, KV, dh)
            seq_ok = shape[2] % tp == 0
            if decode and seq_ok:
                if shard_batch:
                    return (None, baxes, TP, None, None)
                return (None, None, (*baxes, TP), None, None)
            if shard_batch:
                return (None, baxes, None, None, TP)
            return (None, None, baxes, None, TP)
        if leaf_name == "ssm":          # (.., B, H, hd, N)
            return (*(None,) * (nd - 4), b, TP, None, None)
        if leaf_name == "conv":         # (.., B, K-1, C)
            return (*(None,) * (nd - 3), b, None, TP)
        return (None,) * nd

    return map_with_path(lambda path, leaf: Spec(rule(path, leaf)),
                         cache_tree)


# ---------------------------------------------------------------------------
# specs as DTensor placements
# ---------------------------------------------------------------------------


def placements_tree(mesh, spec_tree):
    """A tree of specs as a tree of DTensor placements."""
    return map_with_path(lambda _, spec: placements(spec, mesh), spec_tree)


def local_shape(shape: Sequence[int], mesh, place: Sequence) -> Tuple:
    """This rank's shard of a tensor of global ``shape`` under ``place``:
    each Shard(d) splits dimension d into ``torch.chunk``'s pieces (the
    last ones shorter or empty), the mesh dimensions in order."""
    return tuple(shard_range(n, mesh, place, d)[1]
                 for d, n in enumerate(shape))


def sharded_full(shape: Sequence[int], value, dtype, mesh, place: Sequence,
                 device=None):
    """A DTensor of global ``shape`` filled with ``value``, placed by
    ``place``, each rank filling its own shard (no communication).  Under
    a FakeTensorMode the shard is fake and nothing is allocated."""
    local = torch.full(local_shape(shape, mesh, place), value, dtype=dtype,
                       device=device or mesh.device_type)
    return from_shards(local, mesh, place, shape)


def sharded_cache(cfg: ModelConfig, batch_size: int, cache_len: int,
                  enc_len: int, mesh, dtype=None, decode: bool = False):
    """``model.init_cache``'s cache as DTensors placed by
    ``cache_shardings`` (the sentinel positions and the zeros made on each
    rank).  The tree's shapes come from ``init_cache`` on the meta device
    outside every dispatch mode: inside a step they are not the step's
    work, and a dry-run's analysis would count their global bytes."""
    from torch.utils._python_dispatch import _disable_current_modes
    from ..models.layers import UNWRITTEN
    from ..models.model import init_cache
    with _disable_current_modes():
        abstract = init_cache(cfg, batch_size, cache_len, enc_len=enc_len,
                              dtype=dtype, device="meta")
    specs = cache_shardings(mesh, abstract, cfg, batch_size, decode)
    place = placements_tree(mesh, specs)
    return zip_map(lambda t, pl: sharded_full(
        t.shape, UNWRITTEN if t.dtype == torch.int32 else 0, t.dtype, mesh,
        pl), abstract, place)


@torch.no_grad()
def distribute_params(params, mesh):
    """The model's ``nn.Parameter``s as DTensors placed by
    ``param_shardings``, in place (``params`` is returned).  Real weights
    go through ``distribute_tensor``; abstract ones (``abstract_params``,
    on the meta device) become fake shards of their local shape, which
    must be made under a FakeTensorMode."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    from torch._subclasses.fake_tensor import FakeTensor
    from ..models.model import param_dicts

    for path, pdict in param_dicts(params):
        for name, w in list(pdict.items()):
            spec = param_spec(path + (name,), w, mesh)
            place = placements(spec, mesh)
            if w.is_meta:
                local = torch.empty(local_shape(w.shape, mesh, place),
                                    dtype=w.dtype, device=mesh.device_type)
                if not isinstance(local, FakeTensor):
                    raise RuntimeError("abstract parameters are distributed "
                                       "under a FakeTensorMode only")
                d = from_shards(local, mesh, place, w.shape)
            else:
                d = distribute_tensor(w.detach(), mesh, place)
            pdict[name] = nn.Parameter(d, requires_grad=w.requires_grad)
    return params
