"""Which implementation answers a kernel call, chosen by the tensor's device.

A CPU tensor takes the plain PyTorch version (``kernels/ref.py``).  A CUDA
tensor takes the Hopper kernel (``kernels/fused_select.py``,
``partition_count.py``, ``band_count.py``, ``segmented_select.py``), and a
kernel that cannot build or launch raises: nothing falls back to the plain
version on the card.  Any other device raises.

``run_<kernel>`` returns ``(outputs, route)`` with route ``"kernel"`` or
``"plain"`` so that ``ops`` can count the passes the call really made.
"""
from __future__ import annotations

import torch

from . import band_count as _bc
from . import fused_select as _fs
from . import partition_count as _pc
from . import ref
from . import segmented_select as _ss

KERNEL = "kernel"
PLAIN = "plain"


def route(x: torch.Tensor) -> str:
    """``"kernel"`` for a CUDA tensor, ``"plain"`` for a CPU tensor."""
    if x.device.type == "cuda":
        return KERNEL
    if x.device.type == "cpu":
        return PLAIN
    raise ValueError(f"no implementation for device {x.device}")


def run_fused_select(x: torch.Tensor, pivot, cap: int):
    """One-pivot count+extract over a (P, n_i) batch of shards:
    ``(counts (P, 3), below (P, cap), above (P, cap))``."""
    r = route(x)
    pivot = torch.as_tensor(pivot, dtype=x.dtype, device=x.device)
    if r == KERNEL:
        return _fs.fused_select(x, pivot, cap), r
    return ref.fused_select_ref(x, pivot, cap), r


def run_fused_select_multi(x: torch.Tensor, pivots, cap: int):
    """Q-pivot count+extract over a (P, n_i) batch: ``(counts (P, Q, 3),
    below (P, Q, cap), above (P, Q, cap))``."""
    r = route(x)
    pivots = torch.as_tensor(pivots, dtype=x.dtype, device=x.device)
    if r == KERNEL:
        return _fs.fused_select_multi(x, pivots, cap), r
    return ref.fused_select_multi_ref(x, pivots, cap), r


def run_partition_count(x: torch.Tensor, pivot):
    """(lt, eq, gt) int32 counts of flat x against the pivot (uint32 x:
    unsigned, against a uint32 pivot)."""
    r = route(x)
    if r == KERNEL:
        return _pc.partition_count(x, pivot), r
    if x.dtype == torch.uint32:
        return ref.partition_count_ref(ref.u32_as_int64(x), int(pivot)), r
    return ref.partition_count_ref(x, torch.as_tensor(pivot, dtype=x.dtype)), r


def run_band_count(x: torch.Tensor, lo, hi):
    """0-d int32 count of flat x inside (lo, hi), bounds cast to x's type."""
    r = route(x)
    if r == KERNEL:
        return _bc.band_count(x, lo, hi), r
    return ref.band_count_ref(x, torch.as_tensor(lo, dtype=x.dtype),
                              torch.as_tensor(hi, dtype=x.dtype)), r


def run_byte_histogram(u: torch.Tensor, prefix: int, mask: int, shift: int):
    """(256,) int32 histogram of byte ``shift`` of the sortable uint32 u
    among the elements matching ``(u & mask) == prefix``."""
    r = route(u)
    if r == KERNEL:
        return _fs.byte_histogram(u, prefix, mask, shift), r
    return ref.byte_histogram_ref(u, prefix, mask, shift), r


def run_radix_walk(x: torch.Tensor, k):
    """The sortable uint32 key (0-d int32 bits) that the 4-pass radix select
    finds for rank k in flat x: the kernel forms the keys as it reads x, the
    plain version first computes ``to_sortable_u32(x)``."""
    r = route(x)
    if r == KERNEL:
        return _fs.radix_walk(x, k), r
    return ref.radix_walk_ref(ref.to_sortable_u32(x), int(k)), r


def run_bisect(x: torch.Tensor, k):
    """``run_radix_walk`` for the 32-step bitwise search."""
    r = route(x)
    if r == KERNEL:
        return _pc.bisect(x, k), r
    return ref.bisect_ref(ref.to_sortable_u32(x), int(k)), r


def run_segmented_select(values: torch.Tensor, keys: torch.Tensor,
                         pivots, cap: int):
    """(G, Q)-pivot grouped count+extract over a (P, n_i) batch:
    ``(counts (P, G, Q, 3), below (P, G, Q, cap), above (P, G, Q, cap))``."""
    r = route(values)
    pivots = torch.as_tensor(pivots, dtype=values.dtype, device=values.device)
    if r == KERNEL:
        return _ss.segmented_select(values, keys, pivots, cap), r
    return ref.segmented_select_ref(values, keys, pivots, cap), r
