"""The dry-run CLI (``python -m repro_torch.launch.dryrun``) in a
subprocess, with ``--device cpu --reduced --jobs 4``: each family's
``reduced()`` config on a 2 x 2 ("data", "model") fake world, one cell
each, spanning train, prefill, decode and the sub-quadratic long decode.
Every record must be ``ok`` and within the card's memory, carry the
reference's record keys (those ``experiments/make_roofline_table.py``
reads among them), and its per-chip FLOPs must lie within a stated bound
of ``model_flops / chips``.

The bound, per-chip FLOPs over model_flops / chips (N the parameters,
D the tokens; ``a`` the attention's share of a forward, 4 S H dh a token
a layer over 2 N: the blockwise path computes every block, masked or
not):
  * a train step at most 4/3 + 2 a: remat (``nothing_saveable``) runs
    each block's forward twice, 8 N D against model_flops' 6 N D, and the
    attention's 2 block products a forward become 11 over the step (the
    forward twice, 7 in the blockwise backward's two passes), 11/6 a;
  * serving at most 1 + a;
  * then x 1.5 for products that DTensor's strategies run whole on every
    rank of an axis they do not split, and for a moe config x 4 x 2: its
    experts take ``capacity`` slots each (the reduced capacity factor 4)
    and the dispatch runs on the whole batch on every rank of the data
    axis;
  * at least 1/2: model_flops counts the embedding table, which a gather
    reads without FLOPs (at most half of a reduced config's N).
"""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import REGISTRY                      # noqa: E402
from repro_torch.launch.dryrun import REDUCED_SHAPES          # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = (("granite-8b", "train_4k"), ("olmoe-1b-7b", "prefill_32k"),
         ("qwen2-vl-2b", "decode_32k"), ("mamba2-1.3b", "long_500k"),
         ("zamba2-2.7b", "prefill_32k"),
         ("seamless-m4t-large-v2", "decode_32k"),
         ("h2o-danube-1.8b", "long_500k"))
KEYS = {"arch", "shape", "mesh", "status", "kind", "tokens_per_step",
        "chips", "trace_s", "hlo_flops_per_chip", "hlo_bytes_per_chip",
        "collective_bytes_per_chip", "collective_breakdown",
        "collective_counts", "roofline", "model_flops_total",
        "model_flops_per_chip", "useful_flops_ratio", "memory_analysis"}


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--device",
           "cpu", "--reduced", "--out", str(out), "--jobs", "4"]
    for arch, shape in CELLS:
        cmd += ["--cell", f"{arch}:{shape}:pod1"]
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return {(arch, shape): json.load(open(out / f"{arch}__{shape}__pod1.json"))
            for arch, shape in CELLS}


def _bound(cfg, kind: str, seq: int):
    attn = 0.0
    if cfg.n_heads and cfg.family not in ("ssm",):
        attn = 4 * seq * cfg.n_heads * cfg.d_head * (
            cfg.n_layers + cfg.enc_layers) / (2 * cfg.param_count())
    hi = 1.5 * (4 / 3 + 2 * attn if kind == "train" else 1 + attn)
    if cfg.family == "moe":
        hi *= cfg.moe_capacity_factor * 2
    return 0.5, hi


@pytest.mark.parametrize("cell", CELLS, ids=[a for a, _ in CELLS])
def test_cell_is_ok_on_the_2x2_mesh(records, cell):
    rec = records[cell]
    assert rec["status"] == "ok", rec.get("error")
    assert rec["mesh"] == "2x2" and rec["chips"] == 4
    assert rec["roofline"]["dominant"] in ("compute", "memory",
                                           "collective")
    assert rec["memory_analysis"]["argument_bytes"] > 0
    assert rec["memory_analysis"]["temp_bytes"] > 0
    assert rec["memory_analysis"]["exceeds_card_memory"] is False


def test_records_carry_the_reference_keys(records):
    for cell, rec in records.items():
        assert KEYS <= set(rec), (cell, KEYS - set(rec))
        assert set(rec["collective_breakdown"]) == set(
            rec["collective_counts"]) == {
            "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
            "collective-permute"}
        assert rec["collective_bytes_per_chip"] == sum(
            rec["collective_breakdown"].values())


def test_per_chip_flops_within_the_bound_of_model_flops(records):
    for (arch, shape), rec in records.items():
        cfg = REGISTRY[arch].reduced()
        seq = REDUCED_SHAPES[shape][0]
        lo, hi = _bound(cfg, rec["kind"], seq)
        ratio = rec["hlo_flops_per_chip"] / rec["model_flops_per_chip"]
        assert lo <= ratio <= hi, (arch, shape, ratio, (lo, hi))
