"""Which implementation answers a kernel call, chosen by the tensor's device.

A CPU tensor takes the plain PyTorch version (``kernels/ref.py``).  A CUDA
tensor takes the Hopper kernel (``kernels/fused_select.py``), and a kernel
that cannot build or launch raises: nothing falls back to the plain version
on the card.  Any other device raises.

``run_<kernel>`` returns ``(outputs, route)`` with route ``"kernel"`` or
``"plain"`` so that ``ops`` can count the passes the call really made.
"""
from __future__ import annotations

import torch

from . import fused_select as _fs
from . import ref

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
