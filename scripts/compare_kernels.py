#!/usr/bin/env python3
"""Time the band kernels of two checkouts on one CUDA card, in turns.

    python3 scripts/compare_kernels.py PARENT_TREE CHANGE_TREE [--seed 0]

Each tree is a checkout of this repository, for example the parent commit
unpacked with ``git archive`` into a git-ignored directory.  The script runs
parent, change, change, parent, each in a process of its own that imports
that tree's ``repro_torch`` and builds its kernels.  Each process times
``fused_select`` (the q = 0.5 pivot) and ``fused_select_multi`` (five
pivots) at the main path's shapes (120 x 2^23 float32 normal values from
``--seed``, eps = 1e-4), and ``segmented_select`` at the grouped path's
(the same size of tenant latencies and int32 keys, built as
``chip_smoke.py``'s grouped phase builds them, G x Q = 32 x 2, pivots from
the grouped sketch), with CUDA events, and takes the device time of one
call of each by CUDA kernel from torch.profiler.  It prints one JSON line a
run, with checksums of every output, then the card's name and power limit.
It fails if the two trees' outputs differ.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def worker(tree: str, label: str, seed: int) -> None:
    sys.path[:0] = [os.path.join(tree, "src"), REPO]
    import torch
    import chip_smoke as cs             # timing helpers of this checkout
    from repro_torch.core import local_ops
    from repro_torch.core.sketch import (local_sample_sketch,
                                         query_merged_sketch,
                                         sample_sketch_params)
    from repro_torch.kernels import fused_select as fs
    from repro_torch.kernels import segmented_select as ss

    fs.build()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((cs.P, cs.N_I), generator=gen, device="cuda")
    n = x.numel()
    m, s = sample_sketch_params(n, cs.N_I, cs.EPS, cs.P)
    vals, weights = local_sample_sketch(x, m, s)
    ks = torch.tensor([local_ops.target_rank(n, q) for q in cs.QS],
                      device="cuda")
    pivots = query_merged_sketch(vals.reshape(-1), weights.reshape(-1), ks,
                                 cs.P, m)
    pivot = pivots[cs.QS.index(0.5)]
    cap = local_ops.candidate_cap(n, cs.EPS, cs.N_I)
    del vals, weights
    outs = (*fs.fused_select(x, pivot, cap),
            *fs.fused_select_multi(x, pivots, cap))
    checksum = [_checksum(cs, t) for t in outs]
    del outs
    record = {
        "tree": tree, "label": label,
        "fused_select_ms": cs._event_ms(
            lambda: fs.fused_select(x, pivot, cap), 5),
        "fused_select_multi_ms": cs._event_ms(
            lambda: fs.fused_select_multi(x, pivots, cap), 3),
        "fused_select_profile": cs._profile(
            lambda: fs.fused_select(x, pivot, cap)),
        "fused_select_multi_profile": cs._profile(
            lambda: fs.fused_select_multi(x, pivots, cap)),
    }
    del x
    torch.cuda.empty_cache()

    values, keys, g_pivots, g_cap = grouped_inputs(cs, seed)
    outs = ss.segmented_select(values, keys, g_pivots, g_cap)
    checksum += [_checksum(cs, t) for t in outs]
    del outs
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    record["segmented_select_ms"] = cs._event_ms(
        lambda: ss.segmented_select(values, keys, g_pivots, g_cap), 3)
    record["segmented_select_peak_bytes"] = torch.cuda.max_memory_allocated()
    record["segmented_select_profile"] = cs._profile(
        lambda: ss.segmented_select(values, keys, g_pivots, g_cap), top=12)
    record["checksum"] = checksum
    print(json.dumps(record), flush=True)


def _checksum(cs, t) -> int:
    """The sum of t's raw bits as integers: equal outputs give equal sums,
    sentinels included."""
    return int(cs._bits(t).long().sum())


def grouped_inputs(cs, seed: int):
    """The grouped path's values, keys, (G, Q) pivots and cap, as
    ``chip_smoke.grouped_path`` forms them."""
    import torch
    from repro_torch.core import grouped as gr, local_ops
    values, keys = cs._tenant_data(seed)
    G = cs.GROUPS
    s = gr.grouped_sketch_samples(cs.EPS, cs.N_I)
    vals, wts, counts, mslack = gr._sketch(values, keys, G, s)
    kmat = gr.grouped_target_ranks(counts.sum(0, dtype=torch.int32),
                                   cs.GROUP_QS)
    pivots = gr.query_grouped_sketch(
        vals.transpose(0, 1).reshape(G, -1), wts.transpose(0, 1).reshape(G, -1),
        mslack.sum(0, dtype=torch.int32), kmat)
    del vals, wts
    torch.cuda.empty_cache()
    return values, keys, pivots, local_ops.candidate_cap(values.numel(),
                                                         cs.EPS, cs.N_I)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--worker", nargs=2, metavar=("TREE", "LABEL"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(os.path.abspath(args.worker[0]), args.worker[1], args.seed)
        return 0

    checksums = {}
    for label in ("parent", "change", "change", "parent"):
        tree = getattr(args, label)
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), args.parent,
             args.change, "--seed", str(args.seed), "--worker", tree, label],
            capture_output=True, text=True)
        if proc.returncode:
            sys.stderr.write(proc.stderr[-4000:])
            raise SystemExit(f"the {label} run failed")
        line = proc.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        checksums.setdefault(label, json.loads(line)["checksum"])
    if checksums["parent"] != checksums["change"]:
        raise SystemExit("the two trees' kernels disagree")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
