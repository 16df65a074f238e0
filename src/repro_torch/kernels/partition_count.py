"""Hopper kernel of ``repro/kernels/partition_count.py``.

``partition_count``  replaces ``::partition_count`` (``_count3_kernel``): the
                     int32 (lt, eq, gt) counts of a flat CUDA tensor against
                     one pivot, in one read.  On float32, bfloat16, int32 and
                     float64 data it compares values (IEEE, so -0.0 == +0.0);
                     on uint32 data (sortable keys) it compares unsigned.
``bisect``           the bitwise radix search on the card: 32
                     ``partition_count`` launches that form JAX's
                     sortable-uint32 keys from the data as they read it,
                     each followed by a one-thread step that halves the
                     interval on the device (no host sync).

Source: ``csrc/partition_count.cu``, built and bound by ``cuda_build``.  Plain
versions: ``kernels/ref.py`` (``partition_count_ref``, ``bisect_ref``).  A
wrapper takes CUDA tensors only and raises otherwise; every launch adds one
to ``LAUNCHES["partition_count"]``.
"""
from __future__ import annotations

import torch

from . import cuda_build as cb

BISECT_STEPS = 32               # one count per bit of the uint32 key
_SIGNATURES = {
    "pc_count": ([cb.I, cb.I, cb.P, cb.L, cb.P, cb.P, cb.I, cb.P], cb.I),
    "pc_bisect_step": ([cb.P, cb.P, cb.P, cb.P], cb.I),
}
_SORTABLE_DTYPES = (torch.float32, torch.bfloat16, torch.int32, torch.uint32)

LAUNCHES = {"partition_count": 0}


def _lib():
    return cb.load("partition_count.cu", _SIGNATURES)


def _flat(x: torch.Tensor, sortable: bool) -> torch.Tensor:
    if not x.is_cuda:
        raise ValueError(f"partition_count takes CUDA tensors, got {x.device}")
    ok = _SORTABLE_DTYPES if sortable else (*cb.KEY_DTYPE, torch.uint32)
    if x.dtype not in ok:
        raise TypeError(f"unsupported dtype {x.dtype}")
    if not 1 <= x.numel() < 2 ** 31:
        raise ValueError(f"{x.numel()} elements outside 1 <= n < 2^31")
    return cb.aligned(x.reshape(-1))


def _count_into(x: torch.Tensor, pivot: torch.Tensor, sortable: bool,
                counts: torch.Tensor) -> None:
    """One launch: adds x's (lt, eq, gt) against the pivot on the device
    (x's type, or uint32 bits in an int32 tensor when sortable) to counts."""
    dev = x.device
    with torch.cuda.device(dev):
        n = x.numel()
        blocks = cb.stream_blocks(dev, -(-n * x.element_size() // 16))
        cb.check(_lib().pc_count(cb.DTYPE_CODE[x.dtype], int(sortable),
                                 x.data_ptr(), n, pivot.data_ptr(),
                                 counts.data_ptr(), blocks, cb.stream(dev)),
                 "partition_count")
    LAUNCHES["partition_count"] += 1


def partition_count(x: torch.Tensor, pivot) -> torch.Tensor:
    """(lt, eq, gt) int32 counts of the flat CUDA tensor x against the
    pivot, with ``ref.partition_count_ref`` semantics.  uint32 data compares
    unsigned against a uint32 pivot."""
    x = _flat(x, sortable=False)
    if x.dtype == torch.uint32:
        pv = torch.tensor(int(pivot), dtype=torch.int64).to(torch.int32)
    else:
        pv = torch.as_tensor(pivot, dtype=x.dtype)
    counts = torch.zeros(3, dtype=torch.int32, device=x.device)
    _count_into(x, pv.reshape(1).to(x.device), x.dtype == torch.uint32, counts)
    return counts


def bisect(x: torch.Tensor, k) -> torch.Tensor:
    """The sortable-uint32 key of the k-th smallest (1-based) element of the
    CUDA tensor x (float32, bfloat16, int32 or uint32 keys), as int32 bits of
    a 0-d tensor: JAX's 32-step bit-at-a-time search (``ref.bisect_ref``
    semantics, a k outside [1, n] included), 32 launches."""
    x = _flat(x, sortable=True)
    dev = x.device
    # (lo, hi, mid) = (0, 2^32 - 1, 2^31 - 1) as uint32 bits
    state = torch.tensor([0, -1, 0x7FFFFFFF], dtype=torch.int32, device=dev)
    kk = torch.as_tensor(k, dtype=torch.int32).reshape(1).to(dev)
    counts = torch.zeros((BISECT_STEPS, 3), dtype=torch.int32, device=dev)
    for i in range(BISECT_STEPS):
        _count_into(x, state[2:], True, counts[i])
        with torch.cuda.device(dev):
            cb.check(_lib().pc_bisect_step(counts[i].data_ptr(), kk.data_ptr(),
                                           state.data_ptr(), cb.stream(dev)),
                     "partition_count bisect step")
    return state[0]
