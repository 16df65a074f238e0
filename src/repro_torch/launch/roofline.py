"""Roofline terms under the card's peak rates.

Counterpart of the model-independent half of ``repro/launch/roofline.py``:

  roofline_terms     (FLOPs, bytes, collective bytes) -> compute, memory and
                     collective seconds a chip, and the dominant term
  kernel_roofline    a measured (bytes moved, seconds) pair -> achieved GB/s
                     and its share of the peak memory rate
  peak_hbm_bandwidth the peak memory rate of a platform
  model_flops        6 N D (training) or 2 N D (serving) over the active
                     parameters

  parse_collective_bytes   a step's collective bytes by kind, and counts
  count_collective_phases  its number of collectives

The rates are the NVIDIA H100 SXM's data-sheet figures, not the
reference's TPU v5e ones: 989 TFLOP/s dense bf16 (67 TFLOP/s f32 without
the tensor cores), 3.35 TB/s of HBM3, and NVLink 4 at 450 GB/s a
direction.  NVLink joins the 8 GPUs of one node: a mesh axis of 16 spans
two nodes, whose link is slower, so ``LINK_BW`` overstates such an axis.
The reference's collective parsers read XLA's partitioned HLO text; the
port's read the record of ``step_analysis.analyze``, which counted the
collectives as they ran.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

PEAK_FLOPS = 989e12          # H100 SXM, dense bf16 on the tensor cores
PEAK_FLOPS_F32 = 67e12       # H100 SXM, f32 without the tensor cores
HBM_BW = 3.35e12             # H100 SXM, HBM3 bytes/s
LINK_BW = 450e9              # H100 SXM, NVLink 4 bytes/s a direction
HBM_BYTES = 80e9             # H100 SXM, device memory

# Peak memory rate by platform, bytes/s.  cpu is a placeholder DDR figure:
# CPU numbers compare kernels with each other, never with a peak.
HBM_BW_BY_PLATFORM = {"cuda": HBM_BW, "gpu": HBM_BW, "cpu": 4e10}


def peak_hbm_bandwidth(platform: Optional[str] = None) -> float:
    """Peak memory rate (bytes/s) of ``platform``; None means the card
    where ``torch.cuda.is_available()``, else the CPU.  An unknown
    platform reads as the CPU."""
    if platform is None:
        platform = "cuda" if torch.cuda.is_available() else "cpu"
    return HBM_BW_BY_PLATFORM.get(platform.lower(), HBM_BW_BY_PLATFORM["cpu"])


def kernel_roofline(bytes_moved: float, seconds: float,
                    platform: Optional[str] = None) -> Dict:
    """Achieved against peak memory rate for one measured kernel call:
    ``bytes_moved`` its modelled traffic (each input read once, each output
    written once, times its passes), ``seconds`` its measured time."""
    peak = peak_hbm_bandwidth(platform)
    achieved = bytes_moved / seconds if seconds > 0 else 0.0
    return {
        "bytes_moved": float(bytes_moved),
        "seconds": float(seconds),
        "achieved_gbs": achieved / 1e9,
        "peak_gbs": peak / 1e9,
        "frac_of_peak": achieved / peak if peak else 0.0,
    }


COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


def parse_collective_bytes(analysis: Dict) -> Dict:
    """Per-rank operand bytes of every collective of a step, by kind, and
    under ``"count"`` the number of each, from ``step_analysis.analyze``'s
    record (the reference parses them from HLO text: the same shape of
    answer)."""
    out = {k: int(analysis["collective_bytes"][k]) for k in COLLECTIVES}
    out["count"] = {k: int(analysis["collective_counts"][k])
                    for k in COLLECTIVES}
    return out


def count_collective_phases(analysis: Dict) -> int:
    """Structural round count: the number of collectives the step ran."""
    return sum(parse_collective_bytes(analysis)["count"].values())


def roofline_terms(flops: float, bytes_accessed: float,
                   collective_bytes_per_chip: float, chips: int) -> Dict:
    """Per-chip seconds of each term (the counts are a chip's share, as a
    partitioned program's are), the dominant term and its time."""
    terms = {"compute_s": flops / PEAK_FLOPS,
             "memory_s": bytes_accessed / HBM_BW,
             "collective_s": collective_bytes_per_chip / LINK_BW}
    dom = max(terms, key=terms.get)
    terms["dominant"] = dom.replace("_s", "")
    terms["bound_s"] = terms[dom]
    return terms


def model_flops(cfg, tokens: int, kind: str) -> float:
    """6 N_active D (``kind="train"``) or 2 N_active D (serving)."""
    mult = 6 if kind == "train" else 2
    return mult * cfg.active_param_count() * tokens
