#!/usr/bin/env python3
"""Run one family serve phase of ``chip_smoke.py`` from each of several
checkouts on one CUDA card, in turns.

    python3 scripts/compare_serve_phase.py PHASE ARCH TREE [TREE ...]
    python3 scripts/compare_serve_phase.py vlm_serve_path qwen2-vl-2b \\
        .trees/parent .trees/change .trees/change .trees/parent

Each tree is a checkout of this repository, for example the parent commit
unpacked with ``git archive`` into a git-ignored directory.  Each run is a
process of its own that imports that tree's ``chip_smoke`` and
``repro_torch``, builds its kernels and calls its ``family_serve_path``
(seed 0).  It prints one JSON line a run (the phase's times, busy share
and the launches of its profiled decode step), then the card's name and
power limit; one tree alone gives that phase's whole result line.  It
fails if a run fails.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

KEEP = ("prefill_median_s", "prefill_bound_s", "generate_median_s",
        "decode_s_per_step", "decode_bound_s_per_step", "tokens_per_s",
        "decode_busy_share", "peak_memory_bytes", "wall_s")


def run_one(tree: str, phase: str, arch: str) -> None:
    tree = os.path.abspath(tree)
    sys.path[:0] = [os.path.join(tree, "src"), tree]
    import chip_smoke
    chip_smoke.build_all()
    res, _ = chip_smoke.family_serve_path(phase, arch, 0, chip_smoke.Tally())
    profile = res.pop("profile_decode_step")
    out = {"tree": tree, "phase": phase, "arch": arch,
           **{k: res[k] for k in KEEP},
           "decode_launches": profile.get("kernel_launches"),
           "decode_device_ms": profile.get("device_ms")}
    print(json.dumps({"run": out, "result": res}), flush=True)


def main() -> int:
    if len(sys.argv) >= 2 and sys.argv[1] == "--one":
        run_one(*sys.argv[2:5])
        return 0
    if len(sys.argv) < 4:
        print(__doc__, file=sys.stderr)
        return 2
    phase, arch, trees = sys.argv[1], sys.argv[2], sys.argv[3:]
    for tree in trees:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                        tree, phase, arch], check=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
