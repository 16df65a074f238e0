"""Hopper kernels of ``repro/kernels/fused_select.py``.

``fused_select``        replaces ``::fused_select`` (``_fused_kernel``): for
                        every shard of a (P, n_i) batch, the int32 (lt, eq,
                        gt) counts against one pivot plus both capped
                        candidate bands.
``fused_select_multi``  replaces ``::fused_select_multi``
                        (``_fused_multi_kernel``): the same for Q pivots from
                        the same passes over the data (up to 8 pivots a call).
``byte_histogram``      replaces ``::byte_histogram``
                        (``_byte_histogram_kernel``): the 256-bin histogram
                        of one byte of the sortable-uint32 key among the
                        elements matching a prefix.  ``radix_walk`` chains
                        four launches into the exact k-th smallest key with
                        no host sync.

The first two are one CUDA C++ source, ``csrc/fused_select.cu``, with the
trim, run sort and merge passes of ``csrc/common.cuh`` that ``band_sort``
plans and launches; the third is ``csrc/byte_histogram.cu``.
``cuda_build`` compiles them for ``sm_90a`` at first use and binds them
with ctypes.  Each source's header says what bounds its kernels and how the
design answers it.  Plain versions: ``kernels/ref.py``.

A wrapper takes CUDA tensors only and raises otherwise; choosing the plain
version for a CPU tensor is ``kernels/dispatch.py``'s job.  Every launch adds
one to its kernel's count in ``LAUNCHES``.
"""
from __future__ import annotations

import numpy as np
import torch

from . import band_sort, cuda_build as cb

MULTI_MAX_PIVOTS = 8            # pivots one fused_select_multi launch takes
PASSES_PER_LAUNCH = 2           # full reads of the data per launch
_SIGNATURES = {
    "fs_count": ([cb.I, cb.I, cb.P, cb.L, cb.L, cb.P, cb.I, cb.I, cb.P, cb.P,
                  cb.P, cb.P, cb.P, cb.P, cb.P], cb.I),
    "fs_compact": ([cb.I, cb.I, cb.P, cb.L, cb.L, cb.P, cb.I, cb.P, cb.P, cb.P,
                    cb.P, cb.P], cb.I),
    "fs_num_bins": ([], cb.I),
    **band_sort.signatures("fs"),
}
_HIST_SIGNATURES = {
    "bh_histogram": ([cb.I, cb.P, cb.L, cb.P, cb.I, cb.P, cb.I, cb.P], cb.I),
    "bh_radix_step": ([cb.P, cb.P, cb.P, cb.I, cb.P], cb.I),
}

LAUNCHES = {"fused_select": 0, "fused_select_multi": 0, "byte_histogram": 0}


def build():
    """Build ``csrc/fused_select.cu`` if needed and return the library's
    path (``scripts/compare_kernels.py`` builds each checkout this way)."""
    return cb.build("fused_select.cu")[0]


def _lib():
    return cb.load("fused_select.cu", _SIGNATURES)


def _hist_lib():
    return cb.load("byte_histogram.cu", _HIST_SIGNATURES)


def _prepare(x: torch.Tensor, pivots: torch.Tensor, cap: int):
    if not x.is_cuda:
        raise ValueError(f"fused_select kernels take CUDA tensors, got "
                         f"{x.device}")
    if x.dim() != 2:
        raise ValueError(f"x must be (P, n_i), got shape {tuple(x.shape)}")
    if x.dtype not in cb.KEY_DTYPE:
        raise TypeError(f"unsupported dtype {x.dtype}")
    P, n_i = x.shape
    if not (1 <= P <= 65535 and 1 <= n_i < 2 ** 31):
        raise ValueError(f"shape {tuple(x.shape)} outside P <= 65535, "
                         f"n_i < 2^31")
    if not 1 <= cap <= n_i:
        raise ValueError(f"cap must be in [1, {n_i}], got {cap}")
    x = cb.aligned(x)
    pivots = pivots.reshape(-1).to(device=x.device, dtype=x.dtype).contiguous()
    if pivots.numel() < 1:
        raise ValueError("at least one pivot is needed")
    return x, pivots


def _launch(x: torch.Tensor, pivots: torch.Tensor, cap: int, maxq: int):
    """One launch: two passes over x for up to ``maxq`` pivots."""
    P, n_i = x.shape
    Q = pivots.numel()
    dev = x.device
    lib = _lib()
    rows = P * Q * 2
    i32 = dict(dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        st = cb.stream(dev)
        hist = torch.zeros((P, lib.fs_num_bins()), **i32)
        pin = torch.zeros((P, Q, 2), **i32)
        thr = torch.empty((P, Q, 2), **i32)
        cand = torch.empty((P, Q, 2), **i32)
        thrcnt = torch.empty((P, Q, 2), **i32)
        counts = torch.empty((P, Q, 3), **i32)
        code = cb.DTYPE_CODE[x.dtype]
        cb.check(lib.fs_count(code, maxq, x.data_ptr(), P, n_i,
                              pivots.data_ptr(), Q, cap, hist.data_ptr(),
                              pin.data_ptr(), thr.data_ptr(), cand.data_ptr(),
                              thrcnt.data_ptr(), counts.data_ptr(), st),
                 "fused_select count pass")
        del hist, pin
        # each band's scratch row is exactly as wide as its candidates: the
        # first host sync of the launch
        cand_h = cand.reshape(-1).cpu().numpy()
        off = torch.from_numpy(band_sort.row_offsets(cand_h)).to(dev)
        buf = torch.empty(max(1, int(cand_h.sum(dtype=np.int64))),
                          dtype=cb.KEY_DTYPE[x.dtype], device=dev)
        cursor = torch.zeros(rows, **i32)
        cb.check(lib.fs_compact(code, maxq, x.data_ptr(), P, n_i,
                                pivots.data_ptr(), Q, thr.data_ptr(),
                                off.data_ptr(), cursor.data_ptr(),
                                buf.data_ptr(), st),
                 "fused_select compaction pass")
        below = torch.empty((P, Q, cap), dtype=x.dtype, device=dev)
        above = torch.empty((P, Q, cap), dtype=x.dtype, device=dev)
        # the kept keys set the sort's runs and passes: the second host sync
        band_sort.trim_sort_bands(lib, "fs", code, buf, off, cand, thr, thrcnt,
                                  cap, below, above, st, "fused_select")
    return counts, below, above


def fused_select(x: torch.Tensor, pivot: torch.Tensor, cap: int):
    """Counts and both capped bands of every shard of a (P, n_i) CUDA batch
    against one pivot: ``(counts (P, 3) int32, below (P, cap), above (P,
    cap))`` with ``ref.fused_select_ref`` semantics, bit for bit."""
    x, pivots = _prepare(x, pivot, cap)
    if pivots.numel() != 1:
        raise ValueError("fused_select takes one pivot")
    counts, below, above = _launch(x, pivots, cap, maxq=1)
    LAUNCHES["fused_select"] += 1
    return counts[:, 0], below[:, 0], above[:, 0]


def fused_select_multi(x: torch.Tensor, pivots: torch.Tensor, cap: int):
    """``fused_select`` against Q pivots: ``(counts (P, Q, 3), below (P, Q,
    cap), above (P, Q, cap))``.  Each launch serves up to
    ``MULTI_MAX_PIVOTS`` pivots; more pivots take more launches."""
    x, pivots = _prepare(x, pivots, cap)
    outs = []
    for start in range(0, pivots.numel(), MULTI_MAX_PIVOTS):
        outs.append(_launch(x, pivots[start:start + MULTI_MAX_PIVOTS], cap,
                            maxq=MULTI_MAX_PIVOTS))
        LAUNCHES["fused_select_multi"] += 1
    if len(outs) == 1:
        return outs[0]
    return tuple(torch.cat(parts, dim=1) for parts in zip(*outs))


def launches_for(num_pivots: int) -> int:
    """Launches ``fused_select_multi`` makes for ``num_pivots`` pivots."""
    return -(-num_pivots // MULTI_MAX_PIVOTS)


RADIX_SHIFTS = (24, 16, 8, 0)   # the bytes of the key, high to low


def _hist_input(x: torch.Tensor) -> torch.Tensor:
    if not x.is_cuda:
        raise ValueError(f"byte_histogram takes CUDA tensors, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16, torch.int32,
                       torch.uint32):
        raise TypeError(f"byte_histogram takes float32, bfloat16, int32 or "
                        f"sortable uint32 data, got {x.dtype}")
    if not 1 <= x.numel() < 2 ** 31:
        raise ValueError(f"{x.numel()} elements outside 1 <= n < 2^31")
    return cb.aligned(x.reshape(-1))


def _histogram_into(x: torch.Tensor, params: torch.Tensor, shift: int,
                    hist: torch.Tensor) -> None:
    """One launch: adds the histogram of byte ``shift`` of the keys matching
    ``params = (prefix, mask)`` (uint32 bits in an int32 tensor) to ``hist``.
    x is float32, bfloat16 or int32 (keys formed by to_sortable_u32) or
    uint32 (already keys), flat, aligned."""
    dev = x.device
    with torch.cuda.device(dev):
        n = x.numel()
        blocks = cb.stream_blocks(dev, -(-n * x.element_size() // 16))
        cb.check(_hist_lib().bh_histogram(
            cb.DTYPE_CODE[x.dtype], x.data_ptr(), n, params.data_ptr(), shift,
            hist.data_ptr(), blocks, cb.stream(dev)), "byte_histogram")
    LAUNCHES["byte_histogram"] += 1


def byte_histogram(x: torch.Tensor, prefix, mask, shift: int) -> torch.Tensor:
    """(256,) int32 histogram of byte ``(u >> shift) & 0xFF`` over the keys
    u of the CUDA tensor x with ``(u & mask) == prefix``, with
    ``ref.byte_histogram_ref`` semantics; x is sortable uint32 keys, or
    float32/bfloat16/int32 data whose keys the kernel forms itself."""
    x = _hist_input(x)
    params = torch.tensor([prefix, mask], dtype=torch.int64).to(
        torch.int32).to(x.device)
    hist = torch.zeros(256, dtype=torch.int32, device=x.device)
    _histogram_into(x, params, shift, hist)
    return hist


def radix_walk(x: torch.Tensor, k) -> torch.Tensor:
    """The sortable-uint32 key of the k-th smallest (1-based) element of the
    CUDA tensor x, as int32 bits of a 0-d tensor: four ``byte_histogram``
    launches, each followed by a one-thread step that picks the byte,
    lowers k and extends the prefix on the device (``ref.radix_walk_ref``
    semantics, a k outside [1, n] included)."""
    x = _hist_input(x)
    dev = x.device
    params = torch.zeros(2, dtype=torch.int32, device=dev)
    kk = torch.as_tensor(k, dtype=torch.int32).reshape(1).to(dev)
    hist = torch.zeros((len(RADIX_SHIFTS), 256), dtype=torch.int32, device=dev)
    for i, shift in enumerate(RADIX_SHIFTS):
        _histogram_into(x, params, shift, hist[i])
        with torch.cuda.device(dev):
            cb.check(_hist_lib().bh_radix_step(
                hist[i].data_ptr(), kk.data_ptr(), params.data_ptr(), shift,
                cb.stream(dev)), "byte_histogram radix step")
    return params[0]
