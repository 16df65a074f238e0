"""DTensor helpers shared by the models, the optimizer and the launch
layer: a spec's placements, the DTensor test, and the dry-run's way of
running a long loop of fake shards as meta tensors.  Imports nothing of
the package, so that every layer may import it.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch._subclasses.fake_tensor import FakeTensor, unset_fake_temporarily
from torch.distributed.tensor import DTensor, Replicate, Shard

__all__ = ["is_dtensor", "placements", "shard_range", "from_shards",
           "meta_if_fake"]


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def placements(spec: Sequence, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: Shard(d) on each
    mesh dimension that names tensor dimension d, Replicate elsewhere.  A
    tensor dimension split over several axes is split over them in mesh
    order, the first the major one, as the reference's tuple entries."""
    out = []
    for name in mesh.mesh_dim_names:
        dims = [d for d, entry in enumerate(spec)
                if entry == name or (isinstance(entry, tuple)
                                     and name in entry)]
        if len(dims) > 1:
            raise ValueError(f"axis {name!r} shards dims {dims} of {spec}")
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def shard_range(n: int, mesh, place: Sequence, dim: int) -> tuple:
    """(first index, length) of this rank's shard of a dimension of size
    ``n``, tensor dimension ``dim`` under ``place``: each mesh dimension
    that shards it splits the piece before it into ``torch.chunk``'s
    pieces (the last ones shorter or empty), the mesh dimensions in
    order, as DTensor splits it."""
    start, size = 0, n
    coord = mesh.get_coordinate()
    for i, p in enumerate(place):
        if p.is_shard() and p.dim == dim:
            c = -(-size // mesh.size(i))
            start += min(size, coord[i] * c)
            size = max(0, min(size, (coord[i] + 1) * c) - coord[i] * c)
    return start, size


def from_shards(local: torch.Tensor, mesh, place: Sequence,
                shape: Sequence[int]) -> DTensor:
    """The DTensor of global ``shape`` (contiguous) whose shard on this
    rank is ``local``, placed by ``place``; no communication, no check."""
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= max(1, n)
    return DTensor.from_local(local, mesh, tuple(place), run_check=False,
                              shape=torch.Size(shape),
                              stride=tuple(reversed(stride)))


def meta_if_fake(fn, *args):
    """``fn(*args)``, a tuple of tensors; fake tensors (a dry-run's shards)
    go through it as meta tensors and come back fake.  A loop of
    thousands of small ops costs ~0.7 ms an op under FakeTensorMode
    against ~25 us on meta; both run the same ops on the same shapes, so
    a dispatch mode above them counts the same work."""
    fakes = [a for a in args if isinstance(a, FakeTensor)]
    if not fakes:
        return fn(*args)
    device = fakes[0].device
    with unset_fake_temporarily():
        out = fn(*(torch.empty(a.shape, dtype=a.dtype, device="meta")
                   if isinstance(a, FakeTensor) else a for a in args))
    return tuple(torch.empty(o.shape, dtype=o.dtype, device=device)
                 for o in out)
