"""Atomic checkpoints of pytrees, with retention, in PyTorch.

Counterpart of ``repro/checkpoint/checkpoint.py``.  The layout is the JAX
package's, so that each package restores the other's checkpoints:

    <dir>/step_<N>/manifest.json   {"step", "paths" (``jax.tree_util.keystr``
                                    of each leaf), "dtypes", "shapes",
                                    "extra"}
    <dir>/step_<N>/leaf_<i>.npy    one array per leaf, in JAX's leaf order;
                                   bfloat16 stored as its uint16 bits

A step is written into a temporary directory and renamed into place, so an
interrupted save never corrupts the latest checkpoint.  A training
checkpoint is the tree ``(params, AdamWState)`` with the blocks stacked
(``models.model.stacked``), leaf for leaf the JAX package's.  Arrays carry
no device: ``restore_checkpoint`` puts them on the device asked for (the
reference's ``shardings`` has no single-card counterpart).
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import pytree
from ..core.select import require_device


def _leaf_array(leaf) -> Tuple[np.ndarray, str]:
    """A leaf (tensor or numpy array) as the array to store and its dtype
    name; bfloat16 as its uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        return arr.view(np.uint16), "bfloat16"
    return arr, str(arr.dtype)


def save_checkpoint(directory: str, step: int, tree: Any,
                    extra: Optional[Dict] = None, keep: int = 3) -> str:
    """Atomically write step_<N> of a pytree (tensors or numpy arrays, a
    flat list included); prune to the newest ``keep`` checkpoints."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:010d}")
    tmp = tempfile.mkdtemp(prefix=".ckpt_tmp_", dir=directory)
    try:
        manifest = {"step": int(step), "paths": pytree.paths(tree),
                    "dtypes": [], "shapes": [], "extra": extra or {}}
        for i, leaf in enumerate(pytree.leaves(tree)):   # one on the host
            arr, dtype = _leaf_array(leaf)
            np.save(os.path.join(tmp, f"leaf_{i}.npy"), arr)
            manifest["dtypes"].append(dtype)
            manifest["shapes"].append(list(arr.shape))
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _prune(directory, keep)
    return final


def _prune(directory: str, keep: int) -> None:
    ckpts = sorted(d for d in os.listdir(directory) if d.startswith("step_"))
    for d in ckpts[:-keep] if keep else []:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def latest_step(directory: str) -> Optional[int]:
    """The newest complete step under ``directory``, or None."""
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and
             os.path.exists(os.path.join(directory, d, "manifest.json"))]
    return max(steps) if steps else None


def _manifest(directory: str, step: Optional[int]) -> Tuple[str, Dict]:
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:010d}")
    with open(os.path.join(path, "manifest.json")) as f:
        return path, json.load(f)


def _load_leaf(path: str, i: int, dtype: str) -> torch.Tensor:
    arr = np.load(os.path.join(path, f"leaf_{i}.npy"))
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore_checkpoint(directory: str, template: Any,
                       step: Optional[int] = None,
                       device="cuda") -> Tuple[Any, Dict]:
    """Load step ``step`` (the newest by default) into the structure of
    ``template``, whose tensors (``meta`` ones will do) give each leaf's
    shape and dtype: ``(tree, extra)``, the leaves on ``device``.  A
    checkpoint of another structure or shape raises
    ``ValueError``; a leaf of another dtype is cast to the template's."""
    device = require_device(device)
    path, manifest = _manifest(directory, step)
    want = pytree.leaves(template)
    if len(want) != len(manifest["paths"]):
        raise ValueError(
            f"checkpoint has {len(manifest['paths'])} leaves, template "
            f"{len(want)}: structure changed")
    loaded = []
    for i, tmpl in enumerate(want):
        t = _load_leaf(path, i, manifest["dtypes"][i])
        if list(t.shape) != list(tmpl.shape):
            raise ValueError(f"leaf {i} ({manifest['paths'][i]}) shape "
                             f"{tuple(t.shape)} != template "
                             f"{tuple(tmpl.shape)}")
        loaded.append(t.to(device=device, dtype=tmpl.dtype))
    return pytree.unflatten(template, loaded), manifest["extra"]


def restore_checkpoint_flat(directory: str, step: Optional[int] = None
                            ) -> Tuple[List[torch.Tensor], Dict]:
    """Templateless restore of a flat leaf list: ``(leaves, extra)`` with
    each leaf a CPU tensor of its saved dtype and shape."""
    path, manifest = _manifest(directory, step)
    return ([_load_leaf(path, i, dtype)
             for i, dtype in enumerate(manifest["dtypes"])],
            manifest["extra"])


def save_service_snapshot(directory: str, step: int, service,
                          keep: int = 3) -> str:
    """Persist a ``QuantileService`` (slot table, tick ring, registry,
    window state) as an atomic ``step_<N>`` checkpoint."""
    leaves, extra = service.snapshot()
    return save_checkpoint(directory, step, leaves,
                           extra={"service_snapshot": extra}, keep=keep)


def restore_service_snapshot(directory: str, step: Optional[int] = None,
                             **overrides):
    """Rebuild a ``QuantileService`` from a service snapshot written by
    either package.  ``overrides`` (``fused=``, ``device=``) re-target
    execution; answers do not depend on them, and a restored warm
    ``exact()`` needs no history replay."""
    from ..launch.quantile_service import QuantileService
    leaves, extra = restore_checkpoint_flat(directory, step)
    if "service_snapshot" not in extra:
        raise ValueError(f"step under {directory} is not a service snapshot")
    return QuantileService.from_snapshot(leaves, extra["service_snapshot"],
                                         **overrides)
