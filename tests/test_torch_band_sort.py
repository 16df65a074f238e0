"""The host plan of ``segmented_select``'s band sort (``run_layout``).

Runs on the CPU: the plan is numpy.  The kernels it drives are held
against their plain version on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""
import numpy as np
import pytest

from repro_torch.kernels.segmented_select import run_layout

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
