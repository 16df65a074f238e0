"""The host plan of the band sort that ``fused_select(_multi)`` and
``segmented_select`` share (``kernels/band_sort.py``: ``run_layout``,
``row_offsets``).

Runs on the CPU: the plan is numpy.  The kernels it drives are held
against their plain version on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""
import numpy as np
import pytest

from repro_torch.kernels.band_sort import row_offsets, run_layout

TILE, CAP, CHUNK = 8, 30, 4


def _blocks(lay, i):
    """(row, run or chunk) of each block of launch i, expanded from
    ``first`` as the device's ``expand_blocks`` does."""
    rows = len(lay.runs)
    first = lay.first[i * rows:(i + 1) * rows + 1].astype(np.int64)
    counts = np.diff(first)
    row = np.repeat(np.arange(rows), counts)
    return np.stack([row, np.arange(first[0], first[-1]) - first[row]])


@pytest.mark.parametrize("kept, runs", [
    ([0], [0]), ([1], [1]), ([TILE - 1], [1]), ([TILE], [1]),
    ([TILE + 1], [2]), ([3 * TILE + 5], [4]), ([CAP], [4]),
    ([0, CAP, 2 * TILE + 3, 5], [0, 4, 3, 1]),
])
def test_runs_per_row(kept, runs):
    lay = run_layout(np.array(kept), TILE, CAP, CHUNK)
    assert lay.runs.tolist() == runs


@pytest.mark.parametrize("kept, passes", [
    ([0, 0], 0), ([TILE, 3], 0), ([TILE + 1], 1), ([2 * TILE], 1),
    ([2 * TILE + 1], 2), ([4 * TILE], 2), ([4 * TILE + 1, 1], 3),
    ([9 * TILE, 0, TILE], 4),
])
def test_merge_passes_of_the_widest_row(kept, passes):
    assert run_layout(np.array(kept), TILE, CAP, CHUNK).passes == passes


def test_merge_rows_pad_to_a_multiple_of_the_tile():
    kept = np.array([0, 5, TILE + 1, CAP, 3 * TILE, 1])
    lay = run_layout(kept, TILE, CAP, CHUNK)
    width = np.diff(np.append(lay.merge_off, lay.merge_total))
    # rows of one run (or none) never reach the merge buffer
    assert width.tolist() == [0, 0, 2 * TILE, 4 * TILE, 3 * TILE, 0]
    assert lay.merge_off.dtype == np.int64
    assert lay.merge_total == 9 * TILE


def test_run_sort_has_a_block_per_run_and_one_per_empty_row():
    kept = np.array([0, 3, 2 * TILE + 1, CAP])
    lay = run_layout(kept, TILE, CAP, CHUNK)
    rows, runs = _blocks(lay, 0)
    assert rows.tolist() == [0, 1, 2, 2, 2, 3, 3, 3, 3]
    assert runs.tolist() == [0, 0, 0, 1, 2, 0, 1, 2, 3]
    assert lay.first.dtype == np.int32


@pytest.mark.parametrize("seed", range(4))
def test_merge_blocks_cover_each_pass_once(seed):
    """Pass p has a block per chunk of every row of more than 2^p runs:
    its kept keys before its last pass, cap keys in it."""
    rng = np.random.default_rng(seed)
    kept = rng.choice([0, 1, TILE, TILE + 1, 5 * TILE - 2, CAP, 60], size=9)
    lay = run_layout(kept, TILE, CAP, CHUNK)
    assert lay.starts[0] == 0 and lay.starts[-1] == lay.first[-1]
    assert len(lay.starts) == lay.passes + 2
    assert len(lay.first) == (lay.passes + 1) * len(kept) + 1
    for p in range(lay.passes):
        rows, chunks = _blocks(lay, p + 1)
        for r in range(len(kept)):
            mine = np.sort(chunks[rows == r])
            if lay.runs[r] <= 1 << p:
                assert mine.size == 0
                continue
            end = CAP if lay.runs[r] <= 2 << p else kept[r]
            assert mine.tolist() == list(range(-(-end // CHUNK)))


# The fused kernels' rows: (shard p, pivot q, side) in that order, P * Q * 2
# of them, at the main path's cap and run tile of f32 keys.
F_TILE, F_CAP, F_CHUNK = 32768, 100_666, 2048


def _fused_kept(P, Q, seed):
    """Kept keys of every fused row: about cap where the band was trimmed,
    fewer where a pivot lies near the shard's end (one side short or
    empty)."""
    rng = np.random.default_rng(seed)
    kept = rng.integers(F_CAP, F_CAP + 3000, size=(P, Q, 2))
    kept[:, 0, 0] = rng.integers(0, F_TILE, size=P)      # pivot near the low end
    kept[:, -1, 1] = 0                                   # pivot above every value
    return kept.reshape(-1)


def test_fused_rows_of_the_main_path_take_two_merge_passes():
    P, Q = 120, 5
    kept = _fused_kept(P, Q, 0)
    lay = run_layout(kept, F_TILE, F_CAP, F_CHUNK)
    assert len(lay.runs) == P * Q * 2
    # ~cap kept keys are 4 runs of 32,768: two passes, the last merging cap
    assert lay.passes == 2
    runs = lay.runs.reshape(P, Q, 2)
    assert (runs[:, 0, 0] <= 1).all() and (runs[:, -1, 1] == 0).all()
    assert (runs[:, 1:-1] == 4).all()
    rows, chunks = _blocks(lay, 2)
    full = np.flatnonzero(lay.runs > 2)
    assert np.array_equal(np.unique(rows), full)
    assert (np.bincount(rows, minlength=len(kept))[full]
            == -(-F_CAP // F_CHUNK)).all()


def test_fused_rows_of_one_run_skip_the_merge_buffer():
    """A cap below one run (the single kernel's small caps) sorts every row
    in one block and needs no merge pass."""
    kept = np.array([0, 1, 37, F_TILE, F_TILE, 5])        # P = 1, Q = 3
    lay = run_layout(kept, F_TILE, 37, F_CHUNK)
    assert lay.passes == 0 and lay.merge_total == 0
    rows, runs = _blocks(lay, 0)
    assert rows.tolist() == list(range(6)) and runs.tolist() == [0] * 6


def test_fused_row_with_an_unpaired_last_run():
    """5 runs: pass 0 merges (0, 1), (2, 3) and copies run 4, pass 1 merges
    (01, 23) and copies 4 again, pass 2 merges the two and writes cap."""
    kept = np.array([4 * F_TILE + 10, F_CAP])
    lay = run_layout(kept, F_TILE, F_CAP, F_CHUNK)
    assert lay.runs.tolist() == [5, 4] and lay.passes == 3
    for p, want in ((0, [kept[0], kept[1]]), (1, [kept[0], F_CAP]),
                    (2, [F_CAP, 0])):
        rows, chunks = _blocks(lay, p + 1)
        got = [int(np.sum(rows == r)) for r in range(2)]
        assert got == [-(-n // F_CHUNK) for n in want], p


@pytest.mark.parametrize("cand", [[0], [7], [0, 0, 3], [5, 0, 2, 9],
                                  [2 ** 31 - 1, 2 ** 31 - 1, 4]])
def test_row_offsets_pack_rows_back_to_back(cand):
    off = row_offsets(np.array(cand, dtype=np.int32))
    assert off.dtype == np.int64 and len(off) == len(cand)
    assert off[0] == 0
    assert np.array_equal(off[1:] - off[:-1], np.array(cand[:-1]))


def test_row_offsets_of_the_fused_rows_follow_shard_pivot_side_order():
    cand = np.arange(1, 2 * 3 * 2 + 1).reshape(2, 3, 2)   # (P, Q, side)
    off = row_offsets(cand)
    # row (p, q, side) = 2 * (p * Q + q) + side starts after every row before
    for p in range(2):
        for q in range(3):
            for side in range(2):
                r = 2 * (p * 3 + q) + side
                assert off[r] == cand.reshape(-1)[:r].sum()
