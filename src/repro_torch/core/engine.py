"""The engine's phases, in PyTorch.

Counterpart of ``repro/core/engine.py``.  Only ``phase_resolve`` is ported
so far: the grouped engine resolves its (G, Q) cells through it.  The
sharded phases over ``torch.distributed`` come with the engine's own slice.
"""
from __future__ import annotations

import torch

from . import local_ops


def phase_resolve(pivots: torch.Tensor, ks: torch.Tensor, counts: torch.Tensor,
                  below: torch.Tensor, above: torch.Tensor,
                  cap: int) -> torch.Tensor:
    """Final rank arithmetic (paper Steps 5+9) for each of R rows: pivots
    (R,), target ranks (R,), global counts (R, 3), merged candidate bands
    (R, C) each.  Row r is ``local_ops.resolve`` of its own row, bit for
    bit; all rows sort in one call."""
    lt, eq = counts[:, 0], counts[:, 1]
    need_left = lt - ks + 1
    need_right = ks - (lt + eq)

    def kth(cands: torch.Tensor, k: torch.Tensor, largest: bool):
        srt = local_ops.stable_sort(cands, dim=-1)
        if largest:
            srt = srt.flip(-1)
        idx = (k.clamp(min=1) - 1).clamp(0, srt.shape[-1] - 1)
        return srt.gather(-1, idx.to(torch.int64).unsqueeze(-1)).squeeze(-1)

    left_val = kth(below, need_left, largest=True)
    right_val = kth(above, need_right, largest=False)
    return torch.where(need_left > 0, left_val,
                       torch.where(need_right > 0, right_val, pivots))
