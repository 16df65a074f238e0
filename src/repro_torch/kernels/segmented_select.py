"""Hopper kernel of ``repro/kernels/segmented_select.py``.

``segmented_select``  replaces ``::segmented_select`` (``_segmented_kernel``):
                      for every shard of a (P, n_i) CUDA batch of values with
                      int32 group keys and every cell of a (G, Q) pivot grid,
                      the int32 (lt, eq, gt) counts and both capped candidate
                      bands of the elements with key == g (keys outside
                      [0, G) are ignored), for all P shards in one launch.

Source: ``csrc/segmented_select.cu`` (its header says what bounds the kernel
and how the design answers it), built and bound by ``cuda_build``.  Plain
version: ``kernels/ref.py::segmented_select_ref``.  The wrapper takes CUDA
tensors only and raises otherwise; every launch adds one to
``LAUNCHES["segmented_select"]``.
"""
from __future__ import annotations

import numpy as np
import torch

from . import cuda_build as cb

_SIGNATURES = {
    "ss_groups_per_slice": ([cb.I, cb.I, cb.I], cb.I),
    "ss_hist": ([cb.I, cb.P, cb.P, cb.L, cb.L, cb.P, cb.I, cb.I, cb.I, cb.P,
                 cb.P, cb.P], cb.I),
    "ss_threshold": ([cb.I, cb.P, cb.P, cb.P, cb.L, cb.I, cb.I, cb.I, cb.P,
                      cb.P, cb.P, cb.P, cb.P], cb.I),
    "ss_compact": ([cb.I, cb.P, cb.P, cb.L, cb.L, cb.P, cb.I, cb.I, cb.I, cb.P,
                    cb.P, cb.P, cb.P, cb.P], cb.I),
    "ss_trim": ([cb.I, cb.P, cb.P, cb.P, cb.P, cb.P, cb.L, cb.I, cb.P, cb.P,
                 cb.P], cb.I),
    "ss_gather": ([cb.I, cb.P, cb.P, cb.P, cb.P, cb.P, cb.P, cb.P, cb.P, cb.L,
                   cb.P, cb.P], cb.I),
    "ss_sort": ([cb.I, cb.P, cb.L, cb.L, cb.P], cb.I),
    "ss_emit": ([cb.I, cb.P, cb.P, cb.P, cb.L, cb.L, cb.P, cb.P, cb.P], cb.I),
    "ss_num_bins": ([], cb.I),
    "ss_sort_tile": ([], cb.I),
    "ss_max_pivots": ([], cb.I),
}

LAUNCHES = {"segmented_select": 0}


def _lib():
    return cb.load("segmented_select.cu", _SIGNATURES)


def reads_per_launch(dtype, num_groups: int, num_levels: int) -> int:
    """Full reads of values and keys one launch makes: one histogram pass
    per slice of groups whose histograms fit in shared memory together,
    plus the compaction pass."""
    per = _lib().ss_groups_per_slice(cb.DTYPE_CODE[dtype], num_groups,
                                     num_levels)
    if per < 1:
        raise ValueError(f"{num_levels} levels do not fit one histogram block")
    return -(-num_groups // per) + 1


def _sort_layout(kept: np.ndarray, tile: int):
    """Rows of the sort buffer: each row with kept keys gets a power of two
    of at least one sort tile, rows of one width side by side.  Returns
    (start of each row, its width, [(first key, rows, width)] per width,
    total keys)."""
    kept = kept.astype(np.int64)
    bits = np.frexp(np.maximum(kept - 1, 0).astype(np.float64))[1]
    width = np.left_shift(np.int64(1), bits.astype(np.int64))
    width = np.where(kept > 0, np.maximum(width, tile), 0)
    order = np.argsort(width, kind="stable")
    starts = np.concatenate([[0], np.cumsum(width[order])[:-1]])
    start = np.empty_like(starts)
    start[order] = starts
    groups = []
    for w in np.unique(width[width > 0]):
        rows = np.flatnonzero(width[order] == w)
        groups.append((int(starts[rows[0]]), len(rows), int(w)))
    return start, width, groups, int(width.sum())


def segmented_select(values: torch.Tensor, keys: torch.Tensor,
                     pivots: torch.Tensor, cap: int):
    """Counts and both capped bands of every shard of a (P, n_i) CUDA batch,
    per (group, level) of the (G, Q) pivots: ``(counts (P, G, Q, 3) int32,
    below (P, G, Q, cap), above (P, G, Q, cap))`` with
    ``ref.segmented_select_ref`` semantics, bit for bit."""
    if not (values.is_cuda and keys.is_cuda):
        raise ValueError(f"segmented_select takes CUDA tensors, got "
                         f"{values.device} and {keys.device}")
    if values.dim() != 2 or keys.shape != values.shape:
        raise ValueError(f"values and keys must be matching (P, n_i), got "
                         f"{tuple(values.shape)} and {tuple(keys.shape)}")
    if values.dtype not in cb.KEY_DTYPE:
        raise TypeError(f"unsupported dtype {values.dtype}")
    if keys.dtype != torch.int32:
        raise TypeError(f"keys must be int32, got {keys.dtype}")
    if pivots.dim() != 2:
        raise ValueError(f"pivots must be (G, Q), got {tuple(pivots.shape)}")
    P, n_i = values.shape
    G, Q = pivots.shape
    if not (1 <= P <= 65535 and 1 <= n_i < 2 ** 31):
        raise ValueError(f"shape {tuple(values.shape)} outside P <= 65535, "
                         f"n_i < 2^31")
    if not 1 <= cap <= n_i:
        raise ValueError(f"cap must be in [1, {n_i}], got {cap}")
    lib = _lib()
    if not 1 <= G * Q <= lib.ss_max_pivots():
        raise ValueError(f"G * Q = {G * Q} outside [1, {lib.ss_max_pivots()}]")
    x = cb.aligned(values)
    k = cb.aligned(keys)
    dev = x.device
    pv = pivots.to(device=dev, dtype=x.dtype).contiguous()
    code = cb.DTYPE_CODE[x.dtype]
    rows = P * G * Q * 2
    i32 = dict(dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        st = cb.stream(dev)
        bps = cb.shard_blocks(dev, P, n_i)
        hist = torch.zeros((P, G, lib.ss_num_bins()), **i32)
        pin = torch.zeros((P, G, Q, 3), **i32)
        cb.check(lib.ss_hist(code, x.data_ptr(), k.data_ptr(), P, n_i,
                             pv.data_ptr(), G, Q, bps, hist.data_ptr(),
                             pin.data_ptr(), st), "segmented_select histograms")
        thr = torch.empty((P, G, Q, 2), **i32)
        cand = torch.empty((P, G, Q, 2), **i32)
        thrcnt = torch.empty((P, G, Q, 2), **i32)
        counts = torch.empty((P, G, Q, 3), **i32)
        cb.check(lib.ss_threshold(code, hist.data_ptr(), pin.data_ptr(),
                                  pv.data_ptr(), P, G, Q, cap, thr.data_ptr(),
                                  cand.data_ptr(), thrcnt.data_ptr(),
                                  counts.data_ptr(), st),
                 "segmented_select threshold scan")
        del hist, pin
        # each band's scratch row is exactly as wide as its candidates: the
        # first host sync of the launch
        cand_h = cand.reshape(-1).cpu().numpy().astype(np.int64)
        off_h = np.concatenate([[0], np.cumsum(cand_h)[:-1]])
        off = torch.from_numpy(off_h).to(dev)
        key_dtype = cb.KEY_DTYPE[x.dtype]
        buf = torch.empty(max(1, int(cand_h.sum())), dtype=key_dtype,
                          device=dev)
        cursor = torch.zeros(rows, **i32)
        cb.check(lib.ss_compact(code, x.data_ptr(), k.data_ptr(), P, n_i,
                                pv.data_ptr(), G, Q, bps, thr.data_ptr(),
                                off.data_ptr(), cursor.data_ptr(),
                                buf.data_ptr(), st),
                 "segmented_select compaction pass")
        kept = torch.empty(rows, **i32)
        sub = torch.empty(rows, **i32)
        cb.check(lib.ss_trim(code, buf.data_ptr(), off.data_ptr(),
                             cand.data_ptr(), thr.data_ptr(),
                             thrcnt.data_ptr(), rows, cap, kept.data_ptr(),
                             sub.data_ptr(), st), "segmented_select trim")
        # the kept keys set each row's sort width: the second host sync
        tile = lib.ss_sort_tile()
        start_h, width_h, widths, total = _sort_layout(
            kept.cpu().numpy(), tile)
        sort_off = torch.from_numpy(start_h).to(dev)
        sort_len = torch.from_numpy(width_h).to(dev)
        sbuf = torch.empty(max(1, total), dtype=key_dtype, device=dev)
        cb.check(lib.ss_gather(code, buf.data_ptr(), off.data_ptr(),
                               cand.data_ptr(), thr.data_ptr(), sub.data_ptr(),
                               kept.data_ptr(), sort_off.data_ptr(),
                               sort_len.data_ptr(), rows, sbuf.data_ptr(), st),
                 "segmented_select gather")
        del buf
        item = sbuf.element_size()
        for first, n_rows, width in widths:
            cb.check(lib.ss_sort(code, sbuf.data_ptr() + first * item, n_rows,
                                 width, st), "segmented_select band sort")
        below = torch.empty((P, G, Q, cap), dtype=x.dtype, device=dev)
        above = torch.empty((P, G, Q, cap), dtype=x.dtype, device=dev)
        cb.check(lib.ss_emit(code, sbuf.data_ptr(), sort_off.data_ptr(),
                             kept.data_ptr(), rows, cap, below.data_ptr(),
                             above.data_ptr(), st), "segmented_select emit")
    LAUNCHES["segmented_select"] += 1
    return counts, below, above
