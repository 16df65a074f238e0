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

import repro_torch.kernels as K                               # noqa: E402
from repro_torch.kernels import fused_select as fs, ops, ref  # noqa: E402
from repro_torch.kernels import band_count as bc              # noqa: E402
from repro_torch.kernels import partition_count as pc         # noqa: E402
from repro_torch.kernels import segmented_select as ss        # noqa: E402
from repro_torch.testing import nans                          # noqa: E402

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
    K.reset_launches()
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
    assert K.launches()["fused_select"] == 3 * pv.numel()
    assert K.launches()["fused_select_multi"] == 3 * fs.launches_for(
        pv.numel() + 3)


def _wide_fused_data(dtype, device):
    """(2, 2^20) normal values with a tenth of them ties: both zeros, the
    tiniest subnormals of either sign (in the canonical bin of 0.0 or the
    one below it) and 1.0; for int32, 0, +-1 and 5."""
    rng = np.random.default_rng(12)
    n = 2 * (1 << 20)
    if dtype == torch.int32:
        x = np.rint(rng.normal(size=n) * 1000)
        table = np.array([0.0, 0.0, 1.0, -1.0, 5.0])
    else:
        tiny = 1e-310 if dtype == torch.float64 else 1e-40
        x = rng.normal(size=n) * 100
        table = np.array([-0.0, 0.0, tiny, -tiny, 1.0])
    tie = rng.random(n) < 0.1
    x[tie] = table[rng.integers(0, len(table), int(tie.sum()))]
    return torch.from_numpy(x).to(device=device, dtype=dtype).reshape(2, -1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_kernels_sort_wide_bands_on_card(cuda, dtype):
    """Bands of one run to ten runs of the band sort (cap 40,000 and
    150,000 at 2^20 values a shard), trimmed and whole, with ties and both
    zeros across run boundaries; pivots +-0.0 and their subnormal
    neighbours, the extremes and beyond, duplicated, 9 or more of them
    (two multi launches)."""
    x = _wide_fused_data(dtype, cuda)
    pv = _pivots(x)
    if dtype.is_floating_point:
        tiny = 1e-310 if dtype == torch.float64 else 1e-40
        pv = torch.cat([pv, torch.tensor([tiny, -tiny], dtype=torch.float64,
                                         device=cuda).to(dtype)])
    multi = torch.cat([pv, pv[:3]])
    for cap in (40_000, 150_000):
        for i in range(pv.numel()):
            got = fs.fused_select(x, pv[i], cap)
            want = ref.fused_select_ref(x, pv[i], cap)
            for g, w in zip(got, want):
                assert _bits(g) == _bits(w), (dtype, cap, i)
        got = fs.fused_select_multi(x, multi, cap)
        want = ref.fused_select_multi_ref(x, multi, cap)
        for g, w in zip(got, want):
            assert _bits(g) == _bits(w), (dtype, cap)


@pytest.mark.cuda
def test_kernel_route_counts_two_passes(cuda):
    x = torch.randn(4, 5000, device=cuda)
    ops.reset_hbm_passes()
    ops.fused_count_extract(x, x[0, 0], 64)
    assert ops.hbm_passes() == 2
    ops.reset_hbm_passes()
    ops.fused_count_extract_multi(x, x[0, :5], 64)
    assert ops.hbm_passes() == 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_counting_kernels_match_plain_on_card(cuda, dtype):
    x = _data(dtype, cuda)
    flat = x.reshape(-1)
    pv = _pivots(x)
    for i in range(pv.numel()):
        assert _bits(pc.partition_count(x, pv[i])) == _bits(
            ref.partition_count_ref(flat, pv[i])), (dtype, i)
        lo, hi = pv[i], pv[pv.numel() - 1 - i]
        assert _bits(bc.band_count(x, lo, hi)) == _bits(
            ref.band_count_ref(flat, lo, hi)), (dtype, i)
    if dtype == torch.float64:             # no sortable-u32 domain
        return
    u = ref.to_sortable_u32(x)
    top = int(ref.u32_as_int64(u.reshape(-1))[N]) & 0xFFFF0000
    for prefix, mask, shift in ((0, 0, 24), (top, 0xFFFF0000, 8)):
        want = ref.byte_histogram_ref(u, prefix, mask, shift)
        for src in (x, u):
            assert _bits(fs.byte_histogram(src, prefix, mask, shift)) == \
                _bits(want), (dtype, src.dtype, shift)
    n = x.numel()
    for k in (0, 1, n // 2, n, n + 1):
        assert _bits(fs.radix_walk(x, k)) == _bits(ref.radix_walk_ref(u, k))
        assert _bits(pc.bisect(x, k)) == _bits(ref.bisect_ref(u, k))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_segmented_kernel_matches_plain_on_card(cuda, dtype):
    x = _data(dtype, cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)
    pv = _pivots(x)
    for G, Q, caps in ((4, 2, (1, 37, N)), (1, 1, (5,)), (100, 1, (20,))):
        keys = torch.randint(-1, G + 1, x.shape, generator=gen, device=cuda,
                             dtype=torch.int32)
        grid = pv[torch.arange(G * Q, device=cuda) % pv.numel()].reshape(G, Q)
        for cap in caps:
            got = ss.segmented_select(x, keys, grid, cap)
            want = ref.segmented_select_ref(x, keys, grid, cap)
            for g, w in zip(got, want):
                assert _bits(g) == _bits(w), (dtype, G, Q, cap)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_segmented_kernel_sorts_wide_bands_on_card(cuda, dtype):
    """Bands of 1, T - 1, T, T + 1, 2T + 3, 3T + 5 and 2^17 + 7 kept keys
    (T the run tile of the band sort), whole, cut by the trim, and kept
    below one run; on ties and mixed zeros that straddle run boundaries."""
    tile = ss.run_tile(dtype)
    sizes = [1, tile - 1, tile, tile + 1, 2 * tile + 3, 3 * tile + 5,
             (1 << 17) + 7]
    rng = np.random.default_rng(11)
    keys = np.repeat(np.arange(len(sizes)), sizes)
    keys = torch.from_numpy(rng.permutation(keys).astype(np.int32)).to(cuda)
    table = np.array([-0.0, 0.0, -1.0, 1.0, 2.5])
    x = np.where(rng.random(keys.numel()) < 0.5,
                 table[rng.integers(0, 5, keys.numel())],
                 rng.normal(size=keys.numel()) * 100)
    x = torch.from_numpy(x).to(device=cuda, dtype=dtype).reshape(1, -1)
    keys = keys.reshape(1, -1)
    lo, hi = ((float("-inf"), float("inf")) if dtype.is_floating_point
              else (-2 ** 31, 2 ** 31 - 1))
    grid = torch.tensor([[lo, 0.0, hi]] * len(sizes), dtype=torch.float64)
    grid = grid.to(device=cuda, dtype=dtype)
    for cap in (max(sizes), 3 * tile + 1, tile - 3):
        got = ss.segmented_select(x, keys, grid, cap)
        want = ref.segmented_select_ref(x, keys, grid, cap)
        for g, w in zip(got, want):
            assert _bits(g) == _bits(w), (dtype, cap)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16,
                                   torch.float64))
def test_band_kernels_skip_nan_on_card(cuda, dtype):
    """Quiet NaNs of both signs among +-inf and both zeros, and NaN pivots:
    the fused kernels count a NaN in gt (n - lt - eq) and the segmented one
    on no side; none puts a NaN in a band, and a NaN pivot has no band.  At
    cap = N the above bands reach the top bin, where +NaN's key lies."""
    x = _data(dtype, cuda)
    pos, neg = nans(dtype, cuda)
    flat = x.view(-1)
    flat[::5] = pos
    flat[2::9] = neg
    pv = torch.cat([_pivots(x[~torch.isnan(x)].reshape(1, -1)),
                    nans(dtype, cuda)])
    gen = torch.Generator(device=cuda).manual_seed(5)
    keys = torch.randint(-1, 4, x.shape, generator=gen, device=cuda,
                         dtype=torch.int32)
    grid = pv[torch.arange(3 * 4, device=cuda) % pv.numel()].reshape(3, 4)
    for cap in (37, N):
        for i in range(pv.numel()):
            got = fs.fused_select(x, pv[i], cap)
            want = ref.fused_select_ref(x, pv[i], cap)
            for g, w in zip(got, want):
                assert _bits(g) == _bits(w), (dtype, cap, i)
        got = fs.fused_select_multi(x, pv, cap)
        want = ref.fused_select_multi_ref(x, pv, cap)
        for g, w in zip(got, want):
            assert _bits(g) == _bits(w), (dtype, cap)
        got = ss.segmented_select(x, keys, grid, cap)
        want = ref.segmented_select_ref(x, keys, grid, cap)
        for g, w in zip(got, want):
            assert _bits(g) == _bits(w), (dtype, cap)


@pytest.mark.cuda
def test_new_kernel_routes_count_their_reads(cuda):
    x = torch.randn(4, 5000, device=cuda)
    keys = torch.randint(0, 3, (4, 5000), device=cuda, dtype=torch.int32)
    K.reset_launches()
    cases = ((lambda: ops.count3(x, x[0, 0]), 1),
             (lambda: ops.band_count(x, -1.0, 1.0), 1),
             (lambda: ops.radix_select_kth(x, 7), 4),
             (lambda: ops.radix_select_kth_bitwise(x, 7), 32),
             (lambda: ops.segmented_count_extract(x, keys, x[0, :6].reshape(
                 3, 2), 64), 2))
    for call, passes in cases:
        ops.reset_hbm_passes()
        call()
        assert ops.hbm_passes() == passes
    assert K.launches() == {"fused_select": 0, "fused_select_multi": 0,
                            "byte_histogram": 4, "partition_count": 33,
                            "band_count": 1, "segmented_select": 1}


def _service_answers(device, dtype, fused):
    """One scripted service sequence on ``device``: ragged ticks of host
    and device batches, a dropped stream, warm and cold ``exact``,
    ``exact_all``, ``grouped``, a windowed service's ``windowed`` and
    ``approx_decayed``; the answers as raw bits."""
    from repro_torch.launch import QuantileService, Window
    rng = np.random.default_rng(9)

    def batch(n):
        if dtype == torch.int32:
            return rng.integers(-40, 40, size=n).astype(np.int32)
        v = rng.choice([-0.0, 0.0, 1.5, -1.5], size=n)
        return np.where(rng.random(n) < 0.5, v,
                        rng.normal(size=n)).astype(np.float32)

    out = []
    svc = QuantileService(eps=0.05, dtype=dtype, fused=fused, device=device)
    win = QuantileService(eps=0.05, dtype=dtype, fused=fused, device=device,
                          window_ticks=4, window_subs=2)
    names = [f"s{i}" for i in range(6)]
    for t in range(7):
        lens = rng.integers(0, 3000, size=len(names))
        data = [batch(int(n)) for n in lens]
        if t % 2:
            data = [torch.from_numpy(d).to(device) for d in data]
        svc.ingest_batch(names, data)
        win.ingest_batch(names, data)
        if t == 3:
            svc.drop_stream("s2")
    for name in ("s0", "s2", "s5"):
        for q in (0.01, 0.5, 0.99):
            out += [svc.exact(name, q), svc.exact(name, q, warm=False),
                    svc.approx(name, q), win.windowed(name, q, window=3),
                    win.windowed(name, q, window=Window(values=2500)),
                    win.approx_decayed(name, q, halflife=2.0)]
    out += list(svc.exact_all((0.25, 0.5, 0.9)).values())
    keys = torch.from_numpy(rng.integers(-1, 6, size=5000).astype(
        np.int32)).to(device)
    svc.ingest_grouped("g", torch.from_numpy(batch(5000)).to(device), keys)
    svc.ingest_grouped("g", batch(77), np.arange(77, dtype=np.int32) % 6)
    out.append(svc.grouped("g", (0.5, 0.99), 6))
    return [_bits(t.reshape(-1).to(dtype)) for t in out]


@pytest.mark.cuda
@pytest.mark.parametrize("fused", (False, True))
@pytest.mark.parametrize("dtype", DTYPES)
def test_service_on_card_matches_cpu(cuda, dtype, fused):
    """The card's service answers equal the CPU port's, bit for bit, and
    the fused route launches both service kernels."""
    K.reset_launches()
    got = _service_answers(cuda, dtype, fused)
    launched = K.launches()
    assert got == _service_answers("cpu", dtype, fused)
    if fused:
        assert launched["fused_select"] > 0
        assert launched["segmented_select"] > 0
    else:
        assert launched["fused_select"] == launched["segmented_select"] == 0


def _calibration_answers(device, fused, threads):
    """Scales of a calibrator fed 6 steps of (4, 300) logits (signed zeros
    and large values among them), and the one-shot calibrations."""
    from repro_torch.launch import StreamingCalibrator, serve
    rng = np.random.default_rng(9)
    steps = []
    for _ in range(6):
        x = rng.normal(size=(4, 300)).astype(np.float32) * 3
        x[0, ::7] = -0.0
        x[1, ::11] = 1e30
        steps.append(torch.from_numpy(x).to(device))
    with StreamingCalibrator(0.999, fused=fused, ingest_threads=threads,
                             device=device) as cal:
        for x in steps:
            cal.observe_many({"logits": x})
        out = [cal.scale("logits"), torch.tensor(cal.observed("logits"))]
        if not threads:
            out.append(cal.approx_scale("logits"))
    acts = torch.cat(steps).reshape(24, 3, 100)
    out += [serve.calibrate_int8_scale(acts, device=device),
            serve.calibrate_int8_scales(acts, axis=-1, device=device)]
    return [_bits(t.reshape(-1)) for t in out]


@pytest.mark.cuda
@pytest.mark.parametrize("threads", (0, 2))
@pytest.mark.parametrize("fused", (False, True))
def test_calibration_on_card_matches_cpu(cuda, fused, threads):
    """The serving path's int8 scales on the card equal the CPU port's bit
    for bit: streaming (synchronous or through an ingest pool) and
    one-shot."""
    K.reset_launches()
    got = _calibration_answers(cuda, fused, threads)
    launched = K.launches()
    assert got == _calibration_answers("cpu", fused, threads)
    assert (launched["fused_select"] > 0) == fused


@pytest.mark.cuda
def test_generate_on_card_observes_every_step(cuda):
    """A reduced granite-8b on the card: greedy tokens of the right shape,
    and the warm scale equals a sort of every observed |logit|."""
    from repro_torch.configs import get_config
    from repro_torch.launch import StreamingCalibrator, serve
    from repro_torch.models import model
    cfg = get_config("granite-8b").reduced()
    params = model.init_params(cfg, 0, device=cuda)
    prompts = torch.randint(0, cfg.vocab, (2, 12), device=cuda,
                            dtype=torch.int32)
    seen = []

    class Tap(StreamingCalibrator):
        def observe_many(self, named):
            seen.append(named["logits"].clone())
            super().observe_many(named)

    cal = Tap(0.999, fused=True, device=cuda)
    toks = serve.generate(cfg, params, prompts, gen_len=5, calibrator=cal)
    assert toks.shape == (2, 5) and toks.device.type == cuda.type
    assert len(seen) == 5 and cal.observed("logits") == 5 * 2 * cfg.vocab
    flat = torch.cat(seen).reshape(-1).abs()
    k = int(np.ceil(0.999 * flat.numel()))
    assert _bits(cal.scale("logits").reshape(1)) == _bits(
        torch.sort(flat).values[k - 1].reshape(1))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "arctic-480b"])
def test_moe_block_on_card_routes_as_the_cpu_and_repeats(arch, cuda):
    """``moe_block`` of a reduced moe config in bf16 at capacity factor 1
    (so experts drop assignments): on the card its experts and dropped
    assignments are the CPU's, its output is within 2e-2 of the CPU's max
    |y| and the same bits on every run (the combine adds no atomics)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import model, moe
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              moe_capacity_factor=1.0)
    p_cpu = model.init_params(cfg, 3, device="cpu").blocks[0].p
    p_gpu = {k: v.to(cuda) for k, v in p_cpu.items()}
    gen = torch.Generator().manual_seed(4)
    x = torch.randn((4, 64, cfg.d_model), generator=gen).to(torch.bfloat16)
    T = x.shape[0] * x.shape[1]

    def routing(p, x):
        _, _, top_i = moe.route(p, x.reshape(T, -1), cfg)
        d = moe.dispatch(top_i, moe.capacity(T, cfg), cfg.moe_experts)
        return top_i.cpu(), d.keep.cpu(), d.order.cpu()

    want_i, want_keep, want_order = routing(p_cpu, x)
    got_i, got_keep, got_order = routing(p_gpu, x.to(cuda))
    assert torch.equal(got_i, want_i) and torch.equal(got_order, want_order)
    assert torch.equal(got_keep, want_keep) and not want_keep.all()
    want, _ = moe.moe_block(p_cpu, x, cfg)
    runs = [moe.moe_block(p_gpu, x.to(cuda), cfg)[0] for _ in range(3)]
    assert all(_bits(r) == _bits(runs[0]) for r in runs)
    err = (runs[0].cpu().float() - want.float()).abs().max()
    assert float(err) <= 2e-2 * float(want.float().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-2.7b"])
def test_ssm_decode_on_card_makes_no_host_sync(arch, cuda):
    """A reduced ssm (and hybrid) model in f32 on the card: ``decode_step``
    writes its state, conv ring (and K/V) in place with no host sync
    (``torch.cuda.set_sync_debug_mode("error")`` raises on one), and
    greedy generation gives the CPU port's tokens."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import model
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              param_dtype="float32")
    cpu = model.init_params(cfg, 3, device="cpu")
    card = model.load_params(model.Transformer(cfg, cuda),
                             model.stacked(model.param_tree(cpu)))
    gen = torch.Generator().manual_seed(5)
    prompts = torch.randint(0, cfg.vocab, (2, 12), generator=gen,
                            dtype=torch.int32)
    _, cache = model.prefill(card, {"tokens": prompts.to(cuda)}, cfg,
                             cache_len=16)
    token = prompts[:, -1:].to(cuda)
    at = torch.full((2,), 12, dtype=torch.int32, device=cuda)

    def watched(c):
        return ([c["ssm"], c["conv"]] if arch == "mamba2-1.3b"
                else [c["mamba"]["ssm"], c["shared"]["k"]])

    before = [t.clone() for t in watched(cache)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits, after = model.decode_step(card, token, cache, at, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert after is cache and logits.shape == (2, cfg.vocab)
    assert all(not torch.equal(a, b) for a, b in zip(before, watched(cache)))
    want = serve.generate(cfg, cpu, prompts, gen_len=6)
    got = serve.generate(cfg, card, prompts.to(cuda), gen_len=6)
    assert torch.equal(got.cpu(), want)
