"""Atomic checkpoints of flat leaf lists, with retention, in PyTorch.

Counterpart of ``repro/checkpoint/checkpoint.py`` for flat lists of leaves
(the service snapshots).  The layout is the JAX package's, so that each
package restores the other's checkpoints:

    <dir>/step_<N>/manifest.json   {"step", "paths" ("[i]"), "dtypes",
                                    "shapes", "extra"}
    <dir>/step_<N>/leaf_<i>.npy    one array per leaf; bfloat16 stored as
                                   its uint16 bits

A step is written into a temporary directory and renamed into place, so an
interrupted save never corrupts the latest checkpoint.  The templated
``restore_checkpoint`` of model state is not ported yet.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


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


def save_checkpoint(directory: str, step: int, leaves: Sequence,
                    extra: Optional[Dict] = None, keep: int = 3) -> str:
    """Atomically write step_<N> of a flat list of leaves; prune to the
    newest ``keep`` checkpoints."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:010d}")
    tmp = tempfile.mkdtemp(prefix=".ckpt_tmp_", dir=directory)
    try:
        arrays = [_leaf_array(leaf) for leaf in leaves]
        manifest = {
            "step": int(step),
            "paths": [f"[{i}]" for i in range(len(arrays))],
            "dtypes": [name for _, name in arrays],
            "shapes": [list(arr.shape) for arr, _ in arrays],
            "extra": extra or {},
        }
        for i, (arr, _) in enumerate(arrays):
            np.save(os.path.join(tmp, f"leaf_{i}.npy"), arr)
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


def restore_checkpoint_flat(directory: str, step: Optional[int] = None
                            ) -> Tuple[List[torch.Tensor], Dict]:
    """Templateless restore of a flat leaf list: ``(leaves, extra)`` with
    each leaf a CPU tensor of its saved dtype and shape."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:010d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = []
    for i, dtype in enumerate(manifest["dtypes"]):
        arr = np.load(os.path.join(path, f"leaf_{i}.npy"))
        if dtype == "bfloat16":
            leaves.append(torch.from_numpy(arr.view(np.int16)).view(
                torch.bfloat16))
        else:
            leaves.append(torch.from_numpy(arr))
    return leaves, manifest["extra"]


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
