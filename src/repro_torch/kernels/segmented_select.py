"""Hopper kernel of ``repro/kernels/segmented_select.py``.

``segmented_select``  replaces ``::segmented_select`` (``_segmented_kernel``):
                      for every shard of a (P, n_i) CUDA batch of values with
                      int32 group keys and every cell of a (G, Q) pivot grid,
                      the int32 (lt, eq, gt) counts and both capped candidate
                      bands of the elements with key == g (keys outside
                      [0, G) are ignored), for all P shards in one launch.

Source: ``csrc/segmented_select.cu`` (its header says what bounds the kernel
and how the design answers it) with the run sort and merge passes of
``csrc/common.cuh``, built and bound by ``cuda_build``.  ``run_layout``
plans the band sort on the host from each band's kept keys.  Plain
version: ``kernels/ref.py::segmented_select_ref``.  The wrapper takes CUDA
tensors only and raises otherwise; every launch adds one to
``LAUNCHES["segmented_select"]``.
"""
from __future__ import annotations

from typing import NamedTuple

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
    "ss_trim": ([cb.I, cb.P, cb.P, cb.P, cb.P, cb.P, cb.L, cb.I, cb.P, cb.P],
                cb.I),
    "ss_run_sort": ([cb.I, cb.P, cb.P, cb.P, cb.I, cb.P, cb.P, cb.P, cb.P, cb.L,
                     cb.P], cb.I),
    "ss_merge": ([cb.I, cb.P, cb.P, cb.P, cb.P, cb.P, cb.I, cb.P, cb.P, cb.I,
                  cb.P, cb.P, cb.L, cb.P], cb.I),
    "ss_expand": ([cb.P, cb.L, cb.I, cb.P, cb.P, cb.P], cb.I),
    "ss_run_tile": ([cb.I], cb.I),
    "ss_merge_chunk": ([], cb.I),
    "ss_num_bins": ([], cb.I),
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


def run_tile(dtype) -> int:
    """Keys of one run of the band sort for values of ``dtype``: 128 KB of
    sort keys."""
    return _lib().ss_run_tile(cb.DTYPE_CODE[dtype])


class RunLayout(NamedTuple):
    """How the band sort covers the rows (see ``run_layout``)."""
    runs: np.ndarray       # (rows,) runs of up to `tile` keys in each row
    merge_off: np.ndarray  # (rows,) int64 start of each row in the merge buffer
    merge_total: int       # keys the merge buffer holds
    passes: int            # merge passes the row of most runs needs
    first: np.ndarray      # ((1 + passes) * rows + 1,) int32 first block of
                           # each row in each launch, then the total
    starts: tuple          # first block of the run sort, of each pass, and
                           # the total


def run_layout(kept: np.ndarray, tile: int, cap: int,
               chunk: int) -> RunLayout:
    """The run sort and merge passes over rows of ``kept`` keys each.

    Row r holds ceil(kept[r] / tile) runs; the run sort gives each run a
    block (a row of no keys one block, which writes its sentinels).  A row
    of two runs or more has a row in the merge buffer, padded to a multiple
    of ``tile``.  Pass p merges runs of tile * 2^p keys in the rows of more
    than 2^p runs, one block per ``chunk`` keys of output: ``cap`` keys in
    a row's last pass (the pass after which it is one run), all its keys
    before that.  The blocks of each launch are numbered row by row, from
    ``first``; the device expands them into (row, run or chunk) pairs."""
    kept = np.asarray(kept, dtype=np.int64)
    runs = -(-kept // tile)
    width = np.where(runs >= 2, runs * tile, 0)
    merge_off = np.concatenate([[0], np.cumsum(width)[:-1]]).astype(np.int64)
    top = int(runs.max(initial=0))
    passes = (top - 1).bit_length() if top > 1 else 0
    counts = [np.maximum(runs, 1)]
    for p in range(passes):
        length = np.where(runs <= 2 << p, cap, kept)
        counts.append(np.where(runs > 1 << p, -(-length // chunk), 0))
    first = np.concatenate([[0], np.cumsum(np.concatenate(counts))])
    if first[-1] >= 2 ** 31:
        raise ValueError("the band sort needs more than 2^31 blocks")
    starts = tuple(first[::len(kept)].tolist())
    return RunLayout(runs, merge_off, int(width.sum()), passes,
                     first.astype(np.int32), starts)


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
        cb.check(lib.ss_trim(code, buf.data_ptr(), off.data_ptr(),
                             cand.data_ptr(), thr.data_ptr(),
                             thrcnt.data_ptr(), rows, cap, kept.data_ptr(),
                             st), "segmented_select trim")
        # the kept keys set the sort's runs and passes: the second host sync
        lay = run_layout(kept.cpu().numpy(), lib.ss_run_tile(code), cap,
                         lib.ss_merge_chunk())
        first = torch.from_numpy(lay.first).to(dev)
        blocks = torch.empty((2, lay.starts[-1]), **i32)
        cb.check(lib.ss_expand(first.data_ptr(), first.numel() - 1, rows,
                               blocks[0].data_ptr(), blocks[1].data_ptr(), st),
                 "segmented_select block table")
        below = torch.empty((P, G, Q, cap), dtype=x.dtype, device=dev)
        above = torch.empty((P, G, Q, cap), dtype=x.dtype, device=dev)
        out = (kept.data_ptr(), cap, below.data_ptr(), above.data_ptr())

        def table(i):
            lo, hi = lay.starts[i], lay.starts[i + 1]
            return (blocks[0, lo:].data_ptr(), blocks[1, lo:].data_ptr(),
                    hi - lo)

        cb.check(lib.ss_run_sort(code, buf.data_ptr(), off.data_ptr(), *out,
                                 *table(0), st), "segmented_select run sort")
        if lay.passes:
            merge = torch.empty(max(1, lay.merge_total), dtype=key_dtype,
                                device=dev)
            ends = [(buf, off),
                    (merge, torch.from_numpy(lay.merge_off).to(dev))]
            for p in range(lay.passes):
                (src, src_off), (dst, dst_off) = ends[p % 2], ends[1 - p % 2]
                cb.check(lib.ss_merge(code, src.data_ptr(), src_off.data_ptr(),
                                      dst.data_ptr(), dst_off.data_ptr(), *out,
                                      p, *table(p + 1), st),
                         "segmented_select merge pass")
    LAUNCHES["segmented_select"] += 1
    return counts, below, above
