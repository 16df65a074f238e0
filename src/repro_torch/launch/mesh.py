"""Production mesh definitions, over ``torch.distributed``'s DeviceMesh.

Counterpart of ``repro/launch/mesh.py``.

Single pod: 16 x 16 = 256 ranks, axes ("data", "model").
Multi-pod:  2 x 16 x 16 = 512 ranks, axes ("pod", "data", "model") — the
"pod" axis is the inter-node dimension (batch sharding + hierarchical
gradient reduction); "data" doubles as the FSDP axis; "model" carries
TP/EP/SP.

Functions (never module-level constants), so that importing this module
touches no process group.  A mesh spans the default process group: a real
one (NCCL or gloo, one rank a process) or the fake one that ``fake_world``
starts, where one process plays rank r of a 256- or 512-rank world and
every collective returns at once without moving data — the dry-run's
counterpart of the reference's 512 placeholder CPU devices.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..core.select import require_device

__all__ = ["fake_world", "make_production_mesh", "make_mesh", "batch_axes",
           "axis_sizes"]


def fake_world(world_size: int, rank: int = 0) -> None:
    """Start the fake process group: this process is ``rank`` of
    ``world_size`` ranks, and collectives complete without communicating.
    Process-global, like the reference's ``XLA_FLAGS`` device count: the
    dry-run runs in its own process, and a process holds one world."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device="cuda") -> DeviceMesh:
    """A mesh of ``shape`` over the first prod(shape) ranks of the default
    process group (all of them, or the first 256 of a 512-rank dry-run
    world, as the reference's single-pod mesh takes the first 256
    devices), its dimensions named ``axes``, on ``device``'s type
    (``"cuda"`` without a card raises; the tests pass ``"cpu"``)."""
    device = require_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    n = 1
    for d in shape:
        n *= int(d)
    return DeviceMesh(device.type, torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device="cuda") -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def batch_axes(mesh) -> tuple:
    """Axes that shard the batch dimension."""
    return ("pod", "data") if "pod" in axis_sizes(mesh) else ("data",)


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a DeviceMesh, or of any object whose ``shape``
    is already such a mapping (the tests' stand-in meshes)."""
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh.shape)
