"""Hopper kernel of ``repro/kernels/segmented_select.py``.

``segmented_select``  replaces ``::segmented_select`` (``_segmented_kernel``):
                      for every shard of a (P, n_i) CUDA batch of values with
                      int32 group keys and every cell of a (G, Q) pivot grid,
                      the int32 (lt, eq, gt) counts and both capped candidate
                      bands of the elements with key == g (keys outside
                      [0, G) are ignored), for all P shards in one launch.

Source: ``csrc/segmented_select.cu`` (its header says what bounds the kernel
and how the design answers it) with the run sort and merge passes of
``csrc/common.cuh``, built and bound by ``cuda_build``; ``band_sort``
plans and launches the band sort from each band's kept keys.  Plain
version: ``kernels/ref.py::segmented_select_ref``.  The wrapper takes CUDA
tensors only and raises otherwise; every launch adds one to
``LAUNCHES["segmented_select"]``.
"""
from __future__ import annotations

import numpy as np
import torch

from . import band_sort, cuda_build as cb

_SIGNATURES = {
    "ss_groups_per_slice": ([cb.I, cb.I, cb.I], cb.I),
    "ss_hist": ([cb.I, cb.P, cb.P, cb.L, cb.L, cb.P, cb.I, cb.I, cb.I, cb.P,
                 cb.P, cb.P], cb.I),
    "ss_threshold": ([cb.I, cb.P, cb.P, cb.P, cb.L, cb.I, cb.I, cb.I, cb.P,
                      cb.P, cb.P, cb.P, cb.P], cb.I),
    "ss_compact": ([cb.I, cb.P, cb.P, cb.L, cb.L, cb.P, cb.I, cb.I, cb.I, cb.P,
                    cb.P, cb.P, cb.P, cb.P], cb.I),
    "ss_num_bins": ([], cb.I),
    "ss_max_pivots": ([], cb.I),
    **band_sort.signatures("ss"),
}

LAUNCHES = {"segmented_select": 0}
# G * Q pivots one launch takes: the compaction keeps 52 bytes of state per
# pivot in shared memory (csrc MAX_PIVOTS, which ``ss_max_pivots`` reports)
MAX_PIVOTS = 4096


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


def run_tile(dtype) -> int:
    """Keys of one run of the band sort for values of ``dtype``: 128 KB of
    sort keys."""
    return _lib().ss_run_tile(cb.DTYPE_CODE[dtype])


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
        cand_h = cand.reshape(-1).cpu().numpy()
        off = torch.from_numpy(band_sort.row_offsets(cand_h)).to(dev)
        buf = torch.empty(max(1, int(cand_h.sum(dtype=np.int64))),
                          dtype=cb.KEY_DTYPE[x.dtype], device=dev)
        cursor = torch.zeros(rows, **i32)
        cb.check(lib.ss_compact(code, x.data_ptr(), k.data_ptr(), P, n_i,
                                pv.data_ptr(), G, Q, bps, thr.data_ptr(),
                                off.data_ptr(), cursor.data_ptr(),
                                buf.data_ptr(), st),
                 "segmented_select compaction pass")
        below = torch.empty((P, G, Q, cap), dtype=x.dtype, device=dev)
        above = torch.empty((P, G, Q, cap), dtype=x.dtype, device=dev)
        # the kept keys set the sort's runs and passes: the second host sync
        band_sort.trim_sort_bands(lib, "ss", code, buf, off, cand, thr,
                                  thrcnt, cap, below, above, st,
                                  "segmented_select")
    LAUNCHES["segmented_select"] += 1
    return counts, below, above
