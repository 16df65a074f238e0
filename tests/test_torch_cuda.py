"""The Hopper kernels against their plain PyTorch versions, on the card.

Every case is marked ``cuda`` and skips without a card.  This file imports
neither JAX nor ``ml_dtypes``, so that it runs where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance is zero: counts and bands compare as raw bits.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import fused_select as fs, ops, ref  # noqa: E402

N = 1001                        # not a multiple of any vector width
DTYPES = (torch.float32, torch.bfloat16, torch.int32, torch.float64)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _bits(t):
    view = {2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()]
    return tuple(t.shape), t.contiguous().view(view).cpu().numpy().tobytes()


def _data(dtype, device):
    """(3, N) normal values with both zeros and the sentinels mixed in."""
    rng = np.random.default_rng(6)
    if dtype == torch.int32:
        x = rng.integers(-1000, 1000, size=3 * N)
        x[::97] = np.iinfo(np.int32).min
        x[5::89] = np.iinfo(np.int32).max
        return torch.from_numpy(x.astype(np.int32)).to(device).reshape(3, N)
    x = rng.normal(size=3 * N)
    x[::13] = 0.0
    x[3::17] = -0.0
    x[::97] = -np.inf
    x[5::89] = np.inf
    return torch.from_numpy(x).to(device=device, dtype=dtype).reshape(3, N)


def _pivots(x):
    srt = torch.sort(x.reshape(-1).double()).values
    picks = [srt[len(srt) // 2], srt[len(srt) // 10], srt[0], srt[-1]]
    extra = ([-1001.0, 1001.0] if x.dtype == torch.int32
             else [-1e30, 1e30, 0.0, -0.0, 1.0, -1.0])
    picks += [torch.tensor(v, dtype=torch.float64, device=x.device)
              for v in extra]
    return torch.stack(picks).to(x.dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernels_match_plain_on_card(cuda, dtype):
    x = _data(dtype, cuda)
    pv = _pivots(x)
    fs.reset_launches()
    for cap in (1, 37, N):
        for i in range(pv.numel()):
            got = fs.fused_select(x, pv[i], cap)
            want = ref.fused_select_ref(x, pv[i], cap)
            for g, w in zip(got, want):
                assert _bits(g) == _bits(w), (dtype, cap, i)
        multi = torch.cat([pv, pv[:3]])          # duplicates, two launches
        got = fs.fused_select_multi(x, multi, cap)
        want = ref.fused_select_multi_ref(x, multi, cap)
        for g, w in zip(got, want):
            assert _bits(g) == _bits(w), (dtype, cap)
    assert fs.launches()["fused_select"] == 3 * pv.numel()
    assert fs.launches()["fused_select_multi"] == 3 * fs.launches_for(
        pv.numel() + 3)


@pytest.mark.cuda
def test_kernel_route_counts_two_passes(cuda):
    x = torch.randn(4, 5000, device=cuda)
    ops.reset_hbm_passes()
    ops.fused_count_extract(x, x[0, 0], 64)
    assert ops.hbm_passes() == 2
    ops.reset_hbm_passes()
    ops.fused_count_extract_multi(x, x[0, :5], 64)
    assert ops.hbm_passes() == 2
