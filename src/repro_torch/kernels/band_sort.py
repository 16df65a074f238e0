"""The band sort that ``fused_select`` and ``segmented_select`` share.

Both kernels compact each band's candidates into a row of a packed scratch
buffer, trim the overfull rows in place, and then sort every row with the
run sort and merge passes of ``csrc/common.cuh``, the last pass writing
the bands as values.  This module is the host side of that sort:

``row_offsets``  each row's start in the packed buffer, from the scan's
                 per-row candidate counts;
``run_layout``   how the run sort and the merge passes cover rows of given
                 kept counts (a numpy plan, tested on the CPU);
``trim_sort_bands``  the launches: the trim, the block tables (built on the
                     card from the plan's per-row counts), the run sort,
                     and the merge passes ping-ponging between the scratch
                     rows and one merge buffer.

Each kernel's library exports the same six entry points under its own
prefix (``fs_``, ``ss_``), which ``signatures`` declares.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import cuda_build as cb


def signatures(prefix: str) -> dict:
    """ctypes declarations of a library's band-sort entry points."""
    return {
        f"{prefix}_trim": ([cb.I, cb.P, cb.P, cb.P, cb.P, cb.P, cb.L, cb.I, cb.P,
                            cb.P], cb.I),
        f"{prefix}_run_sort": ([cb.I, cb.P, cb.P, cb.P, cb.I, cb.P, cb.P, cb.P,
                                cb.P, cb.L, cb.P], cb.I),
        f"{prefix}_merge": ([cb.I, cb.P, cb.P, cb.P, cb.P, cb.P, cb.I, cb.P,
                             cb.P, cb.I, cb.P, cb.P, cb.L, cb.P], cb.I),
        f"{prefix}_expand": ([cb.P, cb.L, cb.I, cb.P, cb.P, cb.P], cb.I),
        f"{prefix}_run_tile": ([cb.I], cb.I),
        f"{prefix}_merge_chunk": ([], cb.I),
    }


def row_offsets(cand: np.ndarray) -> np.ndarray:
    """(rows,) int64 start of each row of a packed buffer whose row r holds
    ``cand[r]`` keys: the exclusive prefix sum."""
    cand = np.asarray(cand, dtype=np.int64).reshape(-1)
    return np.concatenate([[0], np.cumsum(cand)[:-1]]).astype(np.int64)


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


def trim_sort_bands(lib, prefix: str, code: int, buf: torch.Tensor,
                    off: torch.Tensor, cand: torch.Tensor, thr: torch.Tensor,
                    thrcnt: torch.Tensor, cap: int, below: torch.Tensor,
                    above: torch.Tensor, st, what: str) -> None:
    """Trim every row of ``buf`` (row r: ``cand[r]`` keys from ``off[r]``,
    its threshold bin ``thr[r]`` holding ``thrcnt[r]`` of them) to about
    ``cap`` kept keys at its front, sort them, and write the first ``cap``
    as values, sentinel padded, into ``below``/``above`` (row 2i is band
    i's below side, row 2i + 1 its above side).  Reads the kept counts on
    the host: a sync.  ``what`` names the kernel in errors."""
    dev = buf.device
    rows = cand.numel()
    kept = torch.empty(rows, dtype=torch.int32, device=dev)
    cb.check(getattr(lib, f"{prefix}_trim")(
        code, buf.data_ptr(), off.data_ptr(), cand.data_ptr(), thr.data_ptr(),
        thrcnt.data_ptr(), rows, cap, kept.data_ptr(), st), f"{what} trim")
    lay = run_layout(kept.cpu().numpy(), getattr(lib, f"{prefix}_run_tile")(code),
                     cap, getattr(lib, f"{prefix}_merge_chunk")())
    first = torch.from_numpy(lay.first).to(dev)
    blocks = torch.empty((2, lay.starts[-1]), dtype=torch.int32, device=dev)
    cb.check(getattr(lib, f"{prefix}_expand")(
        first.data_ptr(), first.numel() - 1, rows, blocks[0].data_ptr(),
        blocks[1].data_ptr(), st), f"{what} block table")
    out = (kept.data_ptr(), cap, below.data_ptr(), above.data_ptr())

    def table(i):
        lo, hi = lay.starts[i], lay.starts[i + 1]
        return blocks[0, lo:].data_ptr(), blocks[1, lo:].data_ptr(), hi - lo

    cb.check(getattr(lib, f"{prefix}_run_sort")(
        code, buf.data_ptr(), off.data_ptr(), *out, *table(0), st),
        f"{what} run sort")
    if not lay.passes:
        return
    merge = torch.empty(max(1, lay.merge_total), dtype=buf.dtype, device=dev)
    ends = [(buf, off), (merge, torch.from_numpy(lay.merge_off).to(dev))]
    for p in range(lay.passes):
        (src, src_off), (dst, dst_off) = ends[p % 2], ends[1 - p % 2]
        cb.check(getattr(lib, f"{prefix}_merge")(
            code, src.data_ptr(), src_off.data_ptr(), dst.data_ptr(),
            dst_off.data_ptr(), *out, p, *table(p + 1), st),
            f"{what} merge pass")
