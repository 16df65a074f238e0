"""The port's batched sketch update and the sketch merges against the JAX
package's, bit for bit (inputs, helpers and tolerances:
``test_torch_sketch.py``)."""
import pytest

torch = pytest.importorskip("torch")

from _grid import DTYPES                                      # noqa: E402
from repro.core import sketch as J                            # noqa: E402
from repro_torch.core import sketch as T                      # noqa: E402

from test_torch_sketch import (BUDGET, _jax_stacked, _x64,
    assert_state)


@pytest.mark.parametrize("dtype", DTYPES)
def test_sketch_update_batch_matches_jax(dtype):
    with _x64(dtype):
        _jax_stacked(dtype, 5, 6, seed=3)


@pytest.mark.parametrize("dtype", DTYPES)
def test_sketch_merges_match_jax(dtype):
    with _x64(dtype):
        ja, ta = _jax_stacked(dtype, 4, 4, seed=5)
        jb_, tb_ = _jax_stacked(dtype, 4, 3, seed=6)
        jc, tc = _jax_stacked(dtype, 4, 2, seed=7)
        assert_state(J.sketch_merge_batch(ja, jb_),
                     T.sketch_merge_batch(ta, tb_))
        for k in (1, 2, 3):
            assert_state(J.sketch_merge_many([ja, jb_, jc][:k]),
                         T.sketch_merge_many([ta, tb_, tc][:k]))
        # one-row merges, an empty side included (row 0 of a fresh table)
        empty_j = J.sketch_unstack(J.sketch_init_stack(
            1, BUDGET, ja.values.dtype))[0]
        empty_t = T.sketch_unstack(T.sketch_init_stack(
            1, BUDGET, ta.values.dtype, device="cpu"))[0]
        rows_j, rows_t = J.sketch_unstack(ja), T.sketch_unstack(ta)
        for a_j, a_t in zip(rows_j, rows_t):
            assert_state(a_j, a_t)
            assert_state(J.sketch_merge(a_j, rows_j[1]),
                         T.sketch_merge(a_t, rows_t[1]))
            assert_state(J.sketch_merge(empty_j, a_j),
                         T.sketch_merge(empty_t, a_t))
        for k in (1, 2, 3, 4):
            assert_state(J.sketch_merge_rows(J.sketch_stack(rows_j[:k])),
                         T.sketch_merge_rows(T.sketch_stack(rows_t[:k])))
        with pytest.raises(ValueError):
            T.sketch_merge(rows_t[0], T.sketch_init(BUDGET // 2,
                                                    ta.values.dtype,
                                                    device="cpu"))
