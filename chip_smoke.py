#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py [--seed 0]

1. Builds the Hopper kernels from ``src/repro_torch/kernels/csrc`` (nvcc,
   sm_90a) and prints the build time.
2. Holds each kernel against its plain PyTorch version on the card, bit for
   bit (tolerance zero), over f32/bf16/int32/f64 x the edge cases (pivots at
   and beyond the extremes, all-equal data, cap above the band and cap =
   n_i, n_i not a multiple of the vector width, duplicate pivots, mixed
   -0.0/+0.0, the dtype's sentinels in the data, heavy ties, more pivots
   than one launch takes).
3. Drives the main path at the paper's size: n = 120 x 2^23 = 1,006,632,960
   float32 normal values from ``--seed`` in (120, 2^23) shards, eps = 1e-4
   (Spark ``percentile_approx``'s default accuracy 10000):
   ``gk_select(q=0.5, block_select=True)`` and ``gk_select_multi(qs=(0.01,
   0.25, 0.5, 0.75, 0.99), block_select=True)``, each equal bit for bit to
   a sort of the whole array on the card.  Every launch count is zeroed just
   before and read just after; both kernels must have launched.  Prints the
   median wall time of 5 runs, each phase's time, the pass count and peak
   memory.
4. Times each kernel at the main path's shapes beside its bound, its plain
   version and the nearest library call, and prints one ``kernels`` JSON line.

Any failure exits non-zero.  The last line is the device record
``{"ok": true, "device": {...}}``; without CUDA, or without the repository
beside it, the script exits non-zero before printing any result.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory (data sheet)
P, N_I, EPS = 120, 1 << 23, 1e-4
QS = (0.01, 0.25, 0.5, 0.75, 0.99)
TIMED_RUNS = 5
DTYPES = (torch.float32, torch.bfloat16, torch.int32, torch.float64)
SOURCE = "src/repro_torch/kernels/csrc/fused_select.cu"
REPLACES = {"fused_select": "src/repro/kernels/fused_select.py:119",
            "fused_select_multi": "src/repro/kernels/fused_select.py:207"}


def _bits(t: torch.Tensor) -> torch.Tensor:
    view = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return t.contiguous().view(view[t.element_size()])


def _same_bits(a, b) -> bool:
    return all(x.shape == y.shape and torch.equal(_bits(x), _bits(y))
               for x, y in zip(a, b))


def _max_abs_err(a, b) -> float:
    err = 0.0
    for x, y in zip(a, b):
        x64, y64 = x.double(), y.double()
        d = torch.where(x64 == y64, torch.zeros_like(x64), (x64 - y64).abs())
        err = max(err, float(d.max()))
    return err


def _sync_time(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _event_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def _profile(fn, top: int = 8) -> dict:
    """Device time by kernel over one call of fn, from torch.profiler, and
    the device's busy share of the call's wall time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA \
                or "Buffer" in evt.name:       # profiler bookkeeping
            continue
        name = evt.name.replace("(anonymous namespace)::", "")
        name = name.replace("void ", "").split("<")[0].split("(")[0]
        name = name.split("::")[-1].strip()
        by_name[name] = by_name.get(name, 0.0) + evt.time_range.elapsed_us() / 1e3
    device_ms = sum(by_name.values())
    if not device_ms:
        return {"wall_ms": wall * 1e3, "device_ms": "not measured"}
    return {"wall_ms": wall * 1e3, "device_ms": device_ms,
            "device_busy_share": device_ms / (wall * 1e3),
            "top_ms": sorted(by_name.items(), key=lambda kv: -kv[1])[:top]}


# ---------------------------------------------------------------------------
# 2. kernel vs plain version, bit for bit
# ---------------------------------------------------------------------------


def _case_data(dtype, kind: str, shape, gen):
    dev = "cuda"
    if kind == "normal":
        if dtype == torch.int32:
            return torch.randint(-10 ** 6, 10 ** 6, shape, generator=gen,
                                 device=dev, dtype=torch.int32)
        return torch.randn(shape, generator=gen, device=dev).to(dtype)
    if kind == "all_equal":
        return torch.full(shape, 7 if dtype == torch.int32 else 3.25,
                          device=dev, dtype=dtype)
    if kind == "ties":
        c = torch.randint(0, 4, shape, generator=gen, device=dev)
        v = torch.where(c == 0, 12.0, torch.where(c == 3, 14.0, 13.0))
        return v.to(dtype)
    if kind == "signed_zeros":
        c = torch.randint(0, 5, shape, generator=gen, device=dev)
        table = torch.tensor([-0.0, 0.0, -1.0, 1.0, 2.0], device=dev)
        return table[c].to(dtype)
    if kind == "sentinels":
        x = _case_data(dtype, "normal", shape, gen)
        lo, hi = ((float("-inf"), float("inf")) if dtype.is_floating_point
                  else (torch.iinfo(dtype).min, torch.iinfo(dtype).max))
        flat = x.view(-1)
        flat[::7] = lo
        flat[3::11] = hi
        return x
    raise ValueError(kind)


def _pivots_for(x: torch.Tensor):
    flat = x.reshape(-1)
    srt = torch.sort(flat.double()).values
    lo, hi = srt[0], srt[-1]
    picks = [srt[len(srt) // 2], srt[len(srt) // 10], lo, hi]
    if x.dtype.is_floating_point:
        picks += [torch.tensor(-1e30 if x.dtype != torch.bfloat16 else -1e38),
                  torch.tensor(1e30 if x.dtype != torch.bfloat16 else 1e38),
                  torch.tensor(0.0), torch.tensor(-0.0)]
    else:
        picks += [torch.tensor(torch.iinfo(torch.int32).min),
                  torch.tensor(torch.iinfo(torch.int32).max)]
    return torch.stack([p.to(x.dtype).cuda() for p in picks])


def kernel_parity(fs, ref) -> dict:
    """Every case through both kernels and both plain versions."""
    gen = torch.Generator(device="cuda").manual_seed(1234)
    cases = [("normal", (3, 1000), [1, 50, 1000]),
             ("normal", (2, 1001), [7, 1001]),
             ("normal", (1, 7), [1, 3, 7]),
             ("normal", (2, 300_001), [5000]),
             ("all_equal", (2, 4096), [16, 4096]),
             ("ties", (3, 20_000), [2000]),
             ("signed_zeros", (2, 3001), [40, 3001]),
             ("sentinels", (2, 5000), [100, 5000])]
    passed = {"fused_select": 0, "fused_select_multi": 0}
    total = dict(passed)
    for dtype in DTYPES:
        for kind, shape, caps in cases:
            x = _case_data(dtype, kind, shape, gen)
            pivots = _pivots_for(x)
            if kind == "signed_zeros" and dtype.is_floating_point:
                pivots = torch.cat([pivots, torch.tensor(
                    [-0.0, 0.0, -1.0, 1.0], device="cuda").to(dtype)])
            for cap in caps:
                for i in range(pivots.numel()):
                    got = fs.fused_select(x, pivots[i], cap)
                    want = ref.fused_select_ref(x, pivots[i], cap)
                    total["fused_select"] += 1
                    if _same_bits(got, want):
                        passed["fused_select"] += 1
                    else:
                        print(f"MISMATCH fused_select {dtype} {kind} "
                              f"{shape} cap={cap} pivot#{i}", flush=True)
                # duplicate pivots and more than one launch's worth
                multi = torch.cat([pivots, pivots[:3]])
                got = fs.fused_select_multi(x, multi, cap)
                want = ref.fused_select_multi_ref(x, multi, cap)
                total["fused_select_multi"] += 1
                if _same_bits(got, want):
                    passed["fused_select_multi"] += 1
                else:
                    print(f"MISMATCH fused_select_multi {dtype} {kind} "
                          f"{shape} cap={cap}", flush=True)
    torch.cuda.synchronize()
    return {name: (passed[name], total[name]) for name in passed}


def signed_zero_path() -> int:
    """The main path's sorts on the card keep jnp.sort's order of -0.0 and
    +0.0: the card's answers equal the CPU port's, bit for bit."""
    from repro_torch.core import gk_select, gk_select_multi, full_sort_quantile
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = _case_data(torch.float32, "signed_zeros", (4, 2000), gen)
    xc = x.cpu()
    bad = 0
    for q in (0.05, 0.2, 0.3, 0.4, 0.45, 0.5, 0.6):
        for kw in ({}, {"speculative": True}, {"block_select": True}):
            if not torch.equal(_bits(gk_select(x, q, **kw).cpu()),
                               _bits(gk_select(xc, q, **kw))):
                bad += 1
        if not torch.equal(_bits(full_sort_quantile(x, q).cpu()),
                           _bits(full_sort_quantile(xc, q))):
            bad += 1
    qs = (0.1, 0.3, 0.5)
    if not torch.equal(_bits(gk_select_multi(x, qs, block_select=True).cpu()),
                       _bits(gk_select_multi(xc, qs))):
        bad += 1
    return bad


# ---------------------------------------------------------------------------
# 3. main path
# ---------------------------------------------------------------------------


def main_path(seed: int) -> dict:
    from repro_torch.core import gk_select, gk_select_multi, local_ops
    from repro_torch.core.sketch import (local_sample_sketch,
                                         query_merged_sketch,
                                         sample_sketch_params)
    from repro_torch.kernels import fused_select as fs, ops, ref

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((P, N_I), generator=gen, device="cuda",
                    dtype=torch.float32)
    n = x.numel()
    k_single = local_ops.target_rank(n, 0.5)
    ks = [local_ops.target_rank(n, q) for q in QS]

    # oracle: one sort of the whole array on the card
    srt = torch.sort(x.reshape(-1)).values
    want_single = srt[k_single - 1].clone()
    want_multi = srt[torch.tensor(ks, device="cuda") - 1].clone()
    del srt
    torch.cuda.empty_cache()

    fs.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    single_s, multi_s = [], []
    got_single = got_multi = None
    for _ in range(TIMED_RUNS + 1):          # first run warms the caches
        got_single, t = _sync_time(
            lambda: gk_select(x, 0.5, eps=EPS, block_select=True))
        single_s.append(t)
        got_multi, t = _sync_time(
            lambda: gk_select_multi(x, QS, eps=EPS, block_select=True))
        multi_s.append(t)
    main_launches = fs.launches()
    peak = torch.cuda.max_memory_allocated()

    if not torch.equal(_bits(got_single), _bits(want_single)):
        raise AssertionError(f"gk_select: {got_single} != oracle {want_single}")
    if not torch.equal(_bits(got_multi), _bits(want_multi)):
        raise AssertionError(f"gk_select_multi: {got_multi} != {want_multi}")
    for name, count in main_launches.items():
        if count < 1:
            raise AssertionError(f"{name} was not launched on the main path")

    ops.reset_hbm_passes()
    gk_select(x, 0.5, eps=EPS, block_select=True)
    passes_single = ops.hbm_passes()
    ops.reset_hbm_passes()
    gk_select_multi(x, QS, eps=EPS, block_select=True)
    passes_multi = ops.hbm_passes()

    # phase breakdown of gk_select(q=0.5, block_select=True), same calls
    phases = {}
    _, phases["nan_check"] = _sync_time(lambda: local_ops.reject_nans(x, "x"))
    m, s = sample_sketch_params(n, N_I, EPS, P)
    (vals, weights), phases["sketch_sort"] = _sync_time(
        lambda: local_sample_sketch(x, m, s))
    kt = torch.tensor(k_single, device="cuda")
    pivot, phases["pivot_query"] = _sync_time(
        lambda: query_merged_sketch(vals.reshape(-1), weights.reshape(-1),
                                    kt, P, m))
    cap = local_ops.candidate_cap(n, EPS, N_I)
    (counts, below, above), phases["count_extract"] = _sync_time(
        lambda: ops.fused_count_extract(x, pivot, cap))
    c = counts.sum(0)
    _, phases["resolve"] = _sync_time(
        lambda: local_ops.resolve(pivot, kt, c[0], c[1], below, above, cap))
    pivots = query_merged_sketch(vals.reshape(-1), weights.reshape(-1),
                                 torch.tensor(ks, device="cuda"), P, m)
    del vals, weights, counts, below, above
    torch.cuda.empty_cache()

    kernels = kernel_timings(x, pivot, pivots, cap, fs, ref, main_launches)
    profiles = {
        "gk_select": _profile(
            lambda: gk_select(x, 0.5, eps=EPS, block_select=True)),
        "gk_select_multi": _profile(
            lambda: gk_select_multi(x, QS, eps=EPS, block_select=True)),
        "fused_select": _profile(lambda: fs.fused_select(x, pivot, cap)),
        "fused_select_multi": _profile(
            lambda: fs.fused_select_multi(x, pivots, cap)),
    }
    return {
        "n": n, "shards": P, "eps": EPS, "cap": cap, "sketch_m": m,
        "sketch_s": s, "answer_q50": float(got_single),
        "answers_multi": [float(v) for v in got_multi],
        "gk_select_median_s": statistics.median(single_s[1:]),
        "gk_select_runs_s": single_s[1:],
        "gk_select_multi_median_s": statistics.median(multi_s[1:]),
        "gk_select_multi_runs_s": multi_s[1:],
        "phases_s": phases, "passes_gk_select": passes_single,
        "passes_gk_select_multi": passes_multi,
        "peak_memory_bytes": peak, "launches": main_launches,
        "profiles": profiles, "kernels": kernels,
    }


def kernel_timings(x, pivot, pivots, cap, fs, ref, main_launches) -> list:
    """Each kernel at the main path's shapes: parity with its plain version
    on these inputs, its time, the plain version's, one library call's, and
    the bound (each input byte read once, each output byte written once)."""
    out = []
    item = x.element_size()
    for name, pv, kernel, plain in (
            ("fused_select", pivot, fs.fused_select, ref.fused_select_ref),
            ("fused_select_multi", pivots, fs.fused_select_multi,
             ref.fused_select_multi_ref)):
        q = pv.numel()
        got = kernel(x, pv, cap)
        want = plain(x, pv, cap)
        if not _same_bits(got, want):
            raise AssertionError(f"{name} differs from its plain version at "
                                 f"the main path's shapes")
        err = _max_abs_err(got, want)
        del got, want
        ms = _event_ms(lambda: kernel(x, pv, cap), 5)
        plain_ms = _event_ms(lambda: plain(x, pv, cap), 2)
        # nearest library call: torch.topk over the masked shards, for the
        # below band of the first pivot only (one side of the work)
        masked = torch.where(x < pv.reshape(-1)[0], x,
                             torch.tensor(float("-inf"), device=x.device))
        library_ms = _event_ms(lambda: torch.topk(masked, cap, dim=-1), 2)
        del masked
        torch.cuda.empty_cache()
        moved = x.numel() * item + q * P * (3 * 4 + 2 * cap * item)
        out.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": main_launches[name],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": moved / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": library_ms,
        })
    return out


# ---------------------------------------------------------------------------


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    import repro_torch  # noqa: F401 — fails outside a checkout of the repo
    from repro_torch.kernels import fused_select as fs, ref
    if "jax" in sys.modules or "repro" in sys.modules:
        raise AssertionError("the port imported JAX or the JAX package")

    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    lib = fs.build()
    build_s = time.perf_counter() - t0
    log = lib.with_name(lib.name + ".log").read_text() \
        if lib.with_name(lib.name + ".log").exists() else ""
    spills = [ln for ln in log.splitlines()
              if "spill" in ln and not ln.strip().startswith("0 bytes")
              and " 0 bytes spill stores" not in ln]
    print(json.dumps({"build_s": build_s, "library": lib.name,
                      "ptxas_spill_lines": spills}), flush=True)

    parity = kernel_parity(fs, ref)
    print(json.dumps({"parity": {k: f"{p}/{t}" for k, (p, t) in parity.items()}}),
          flush=True)
    for name, (p, t) in parity.items():
        if p != t:
            raise AssertionError(f"{name}: {t - p} of {t} cases differ from "
                                 f"the plain version")
    bad = signed_zero_path()
    print(json.dumps({"signed_zero_mismatches": bad}), flush=True)
    if bad:
        raise AssertionError("signed-zero answers differ between card and CPU")

    result = main_path(args.seed)
    kernels = result.pop("kernels")
    print(json.dumps({"main_path": result}), flush=True)
    for k in kernels:
        k["parity_cases"] = "{}/{}".format(*parity[k["name"]])

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
