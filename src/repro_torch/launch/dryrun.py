"""Multi-pod dry-run: trace every (arch x shape x mesh) cell once on one
rank of a fake world and record per-rank FLOPs, memory traffic,
collectives and memory — the proof that the distribution config is
coherent on the production meshes (16x16 and 2x16x16).

Counterpart of ``repro/launch/dryrun.py``, which lowers and compiles each
cell for 512 placeholder CPU devices.  Here one process starts a fake
process group of 256 or 512 ranks (``mesh.fake_world``) and plays rank 0:
the step runs eagerly on DTensors whose shards are fake tensors (shapes
and dtypes, nothing allocated) under ``step_analysis.StepAnalysis``, and
every collective returns at once.  A cell's figures are estimates under
the H100's data-sheet rates (``roofline``), not measurements.  Must run
as its own process: a process holds one world.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
      --shape all --mesh both --out experiments/dryrun_torch [--force] \\
      [--device cpu] [--reduced] [--cell ARCH:SHAPE:MESH ...] [--jobs N]

``--jobs N`` traces each cell in a process of its own, N at once (a
cell's trace is one host thread, and a process holds one world).
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import torch

from ..configs import REGISTRY
from ..core.select import require_device
from ..models.model import Transformer, param_tree
from ..pytree import leaves
from . import roofline as rf
from .mesh import fake_world, make_mesh
from .step_analysis import StepAnalysis
from .steps import SHAPES, distribute_inputs, input_specs, shape_applicable

_WORLD = None      # the fake world's size, once started

# ``--reduced``: each family's ``reduced()`` config on a 2 x 2 (2 x 2 x 2)
# mesh, at these (seq, global batch) — the same code paths at toy size
REDUCED_SHAPES = {"train_4k": (64, 8), "prefill_32k": (64, 4),
                  "decode_32k": (64, 8), "long_500k": (128, 1)}


def _fake_mode():
    """A FakeTensorMode for a cell, with DTensor's strided-shard size
    helper run on real tensors: it builds index tensors and reads them
    back (``tolist``), which a fake tensor cannot do (torch 2.13)."""
    from torch._subclasses.fake_tensor import (FakeTensorMode,
                                               unset_fake_temporarily)
    from torch.distributed.tensor import placement_types as pt
    strided = getattr(pt, "_StridedShard", None)
    fn = getattr(strided, "local_shard_size_and_offset", None)
    if fn is not None and not getattr(fn, "_outside_fake", False):
        @functools.wraps(fn)
        def outside_fake(*a, **k):
            with unset_fake_temporarily():
                return fn(*a, **k)
        outside_fake._outside_fake = True
        strided.local_shard_size_and_offset = outside_fake
    return FakeTensorMode()


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor
    total = 0
    for t in leaves(param_tree(tree) if isinstance(tree, Transformer)
                    else tree):
        if isinstance(t, torch.Tensor):
            t = t.to_local() if isinstance(t, DTensor) else t
            total += t.numel() * t.element_size()
    return total


def _tag(arch: str, shape: str, multi_pod: bool) -> str:
    return f"{arch}__{shape}__{'pod2' if multi_pod else 'pod1'}"


def run_cell(arch: str, shape: str, multi_pod: bool, out_dir: str,
             force: bool = False, device="cuda", verbose: bool = True,
             reduced: bool = False) -> dict:
    """Trace one cell and write its record to ``out_dir/<tag>.json`` (a
    record already there is returned unless ``force``).  ``device`` is
    the fake tensors' device (``"cuda"`` without a card raises).
    ``reduced`` runs the config's ``reduced()`` variant on a 2 x 2 (pod2:
    2 x 2 x 2) mesh at ``REDUCED_SHAPES``."""
    global _WORLD
    device = require_device(device)
    tag = _tag(arch, shape, multi_pod)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, tag + ".json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)

    cfg = REGISTRY[arch].reduced() if reduced else REGISTRY[arch]
    ok, why = shape_applicable(cfg, shape)
    side = 2 if reduced else 16
    mesh_shape = (2, side, side) if multi_pod else (side, side)
    rec = {"arch": arch, "shape": shape,
           "mesh": "x".join(map(str, mesh_shape))}
    if not ok:
        rec.update(status="skipped", reason=why)
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        return rec

    if _WORLD is None:
        _WORLD = 2 * side * side
        fake_world(_WORLD)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    mesh = make_mesh(mesh_shape, axes, device)
    chips = mesh.size()
    t0 = time.time()
    try:
        with _fake_mode():
            fn, args, in_pl, _, meta = input_specs(
                cfg, shape, mesh,
                seq_batch=REDUCED_SHAPES[shape] if reduced else None)
            args = distribute_inputs(args, in_pl, mesh)
            arg_bytes = _local_bytes(args[0]) + sum(
                _local_bytes(a) for a in args[1:])
            ana_mode = StepAnalysis()
            with ana_mode:
                out = fn(*args)
            t_trace = time.time() - t0
            out_bytes = sum(_local_bytes(o) for o in out
                            if not isinstance(o, Transformer))
        ana = ana_mode.result()
        flops = ana["flops"]
        bytes_acc = ana["traffic_bytes"]
        coll_bytes = ana["collective_total_bytes"]
        terms = rf.roofline_terms(flops, bytes_acc, coll_bytes, chips)
        mf = rf.model_flops(cfg, meta["tokens_per_step"], meta["kind"])
        rec.update(
            status="ok",
            kind=meta["kind"],
            tokens_per_step=meta["tokens_per_step"],
            chips=chips,
            trace_s=round(t_trace, 1),
            hlo_flops_per_chip=flops,
            hlo_bytes_per_chip=bytes_acc,
            collective_bytes_per_chip=coll_bytes,
            collective_breakdown=ana["collective_bytes"],
            collective_result_breakdown=ana["collective_result_bytes"],
            collective_counts=ana["collective_counts"],
            roofline=terms,
            model_flops_total=mf,
            model_flops_per_chip=mf / chips,
            useful_flops_ratio=(mf / chips) / flops if flops else 0.0,
            memory_analysis={
                "argument_bytes": arg_bytes,
                "output_bytes": out_bytes,
                "temp_bytes": ana["peak_bytes"],
                # the largest tensors live at that peak (the step's own)
                "peak_tensors": ana["peak_tensors"],
                "generated_code_bytes": None,
                # arguments and the step's peak together past the card's
                # memory: the cell would not run on an H100 as planned
                "exceeds_card_memory":
                    arg_bytes + ana["peak_bytes"] > rf.HBM_BYTES,
            },
        )
        if verbose:
            print(f"[ok] {tag}: trace {t_trace:.0f}s  "
                  f"flops/chip {flops:.3g}  bytes/chip {bytes_acc:.3g}  "
                  f"coll/chip {coll_bytes:.3g}  dominant {terms['dominant']}"
                  f"  args {arg_bytes / 1e9:.3g} GB  peak "
                  f"{ana['peak_bytes'] / 1e9:.3g} GB"
                  + ("  EXCEEDS CARD MEMORY" if rec["memory_analysis"][
                      "exceeds_card_memory"] else ""), flush=True)
            for t in ana["peak_tensors"]:
                print(f"    peak {t['bytes'] / 1e9:.3g} GB {t['dtype']}"
                      f"{t['shape']} {t.get('placements', '')} "
                      f"{t['op']} at {t['at']}", flush=True)
    except Exception as e:  # a failing cell is a bug; record it loudly
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
        if verbose:
            print(f"[ERROR] {tag}: {type(e).__name__}: {e}", flush=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["pod1", "pod2", "both"])
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced configs on a 2x2 (2x2x2) mesh, toy shapes")
    ap.add_argument("--cell", action="append", default=[],
                    metavar="ARCH:SHAPE:MESH",
                    help="one cell (pod1 or pod2), in place of the "
                         "--arch x --shape x --mesh grid; repeatable")
    ap.add_argument("--jobs", type=int, default=1,
                    help="trace the cells in this many processes at once")
    args = ap.parse_args(argv)

    archs = sorted(REGISTRY) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"pod1": [False], "pod2": [True], "both": [False, True]}[args.mesh]
    cells = [(a, s, mp) for a in archs for s in shapes for mp in meshes]
    if args.cell:
        cells = [(a, s, m == "pod2") for a, s, m in
                 (c.split(":") for c in args.cell)]

    if args.jobs > 1 and len(cells) > 1:
        records = _run_parallel(cells, args)
    else:
        records = [run_cell(arch, shape, mp, args.out, force=args.force,
                            device=args.device, reduced=args.reduced)
                   for arch, shape, mp in cells]
    n_ok = n_skip = n_err = 0
    for rec in records:
        st = rec["status"]
        n_ok += st == "ok"
        n_skip += st == "skipped"
        n_err += st == "error"
    print(f"\ndry-run summary: ok={n_ok} skipped={n_skip} error={n_err}")
    if n_err:
        raise SystemExit(1)


def _run_parallel(cells, args) -> list:
    """The cells' records, each traced by a child process of this CLI, at
    most ``args.jobs`` at once, the slowest shapes (prefill, then train)
    started first; a cell whose record is missing afterwards counts as an
    error."""
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--out",
           args.out, "--device", args.device]
    cmd += ["--force"] * args.force + ["--reduced"] * args.reduced
    first = {"prefill_32k": 0, "train_4k": 1}
    queue = sorted(cells, key=lambda c: first.get(c[1], 2))
    running = []
    while queue or running:
        while queue and len(running) < args.jobs:
            a, s, mp = queue.pop(0)
            log = tempfile.TemporaryFile("w+")
            running.append((subprocess.Popen(
                cmd + ["--cell", f"{a}:{s}:{'pod2' if mp else 'pod1'}"],
                stdout=log, stderr=subprocess.STDOUT), log))
        done = next((r for r in running if r[0].poll() is not None), None)
        if done is None:
            time.sleep(0.2)
            continue
        running.remove(done)
        # the child's cell line; all of its output where it failed
        proc, log = done
        log.seek(0)
        out = log.readlines()
        log.close()
        if not proc.returncode:
            out = [ln for ln in out
                   if ln.startswith(("[ok]", "[ERROR]", "    peak"))]
        print("".join(out), end="", flush=True)
    records = []
    for cell in cells:
        path = os.path.join(args.out, _tag(*cell) + ".json")
        if os.path.exists(path):
            with open(path) as f:
                records.append(json.load(f))
        else:
            print(f"[ERROR] {_tag(*cell)}: no record", flush=True)
            records.append({"status": "error", "error": "no record"})
    return records


if __name__ == "__main__":
    main()
