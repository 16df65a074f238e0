"""Hopper kernel of ``repro/kernels/band_count.py``.

``band_count``  replaces ``::band_count`` (``_band_count_kernel``): the int32
                count of elements of a flat CUDA tensor with lo < x < hi, by
                IEEE comparison on float32, bfloat16, int32 or float64 data,
                in one read.

Source: ``csrc/band_count.cu``, built and bound by ``cuda_build``.  Plain
version: ``kernels/ref.py::band_count_ref``.  The wrapper takes CUDA tensors
only and raises otherwise; every launch adds one to ``LAUNCHES["band_count"]``.
"""
from __future__ import annotations

import torch

from . import cuda_build as cb

_SIGNATURES = {
    "bc_count": ([cb.I, cb.P, cb.L, cb.P, cb.P, cb.I, cb.P], cb.I),
}

LAUNCHES = {"band_count": 0}


def _lib():
    return cb.load("band_count.cu", _SIGNATURES)


def band_count(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """0-d int32 count of the elements of the CUDA tensor x inside the open
    band (lo, hi), with ``ref.band_count_ref`` semantics (bounds cast to x's
    type)."""
    if not x.is_cuda:
        raise ValueError(f"band_count takes CUDA tensors, got {x.device}")
    if x.dtype not in cb.KEY_DTYPE:
        raise TypeError(f"unsupported dtype {x.dtype}")
    if not 1 <= x.numel() < 2 ** 31:
        raise ValueError(f"{x.numel()} elements outside 1 <= n < 2^31")
    x = cb.aligned(x.reshape(-1))
    dev = x.device
    bounds = torch.stack([torch.as_tensor(b, dtype=x.dtype).reshape(())
                          .to(dev) for b in (lo, hi)])
    out = torch.zeros(1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        n = x.numel()
        blocks = cb.stream_blocks(dev, -(-n * x.element_size() // 16))
        cb.check(_lib().bc_count(cb.DTYPE_CODE[x.dtype], x.data_ptr(), n,
                                 bounds.data_ptr(), out.data_ptr(), blocks,
                                 cb.stream(dev)), "band_count")
    LAUNCHES["band_count"] += 1
    return out[0]
