#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py [--seed 0]

1. Builds every Hopper kernel from ``src/repro_torch/kernels/csrc`` (one nvcc
   per source, sm_90a, all started together) and prints the build time and
   each library's ptxas spill lines, each with the kernel it belongs to.
2. Holds each of the six kernels against its plain PyTorch version on the
   card, bit for bit (tolerance zero), and prints passed/total per kernel:
   f32/bf16/int32/f64 (the sortable-u32 domain for byte_histogram) x the
   edge cases (pivots at and beyond the extremes, all-equal data, ties,
   mixed -0.0/+0.0, the dtype's sentinels in the data, n not a multiple of
   the vector width, cap = n_i, duplicate pivots, more pivots than one
   launch takes; for the three band kernels also quiet NaNs of both signs
   among +-inf, +-0.0 and the sentinels, NaN pivots, and at cap = n_i
   above bands that reach the top bin; for both fused kernels also bands
   wider than one run of
   the band sort at 2^20 values a shard: 1 to 10 runs, trimmed and whole,
   ties and mixed -0.0/+0.0 across run boundaries, pivots +-0.0 beside
   subnormal neighbours in their canonical bin; for segmented_select also
   empty groups, keys -1 and G, one group holding all the data, G*Q = 1,
   G*Q too large for one block's shared memory, and bands wider than one
   run of the band sort: kept counts 1, T - 1, T, T + 1, 2T + 3, 3T + 5
   and at least 2^17 (T the run tile), a band the trim cuts, ties and mixed
   -0.0/+0.0 across run boundaries, rows of an odd number of runs; for the
   radix walks a k outside [1, n]).
3. Checks that the card's sorts, argmins and answers equal the CPU port's
   on signed zeros and ties, bit for bit.
4. Drives the main path at the paper's size: n = 120 x 2^23 = 1,006,632,960
   float32 normal values from ``--seed`` in (120, 2^23) shards, eps = 1e-4
   (Spark ``percentile_approx``'s default accuracy 10000):
   ``gk_select(q=0.5, block_select=True)`` and ``gk_select_multi(qs=(0.01,
   0.25, 0.5, 0.75, 0.99), block_select=True)``, each equal bit for bit to
   a sort of the whole array on the card.
5. Drives the counting and radix entry points on the same array:
   ``radix_select_kth`` and ``radix_select_kth_bitwise`` at the median rank
   (bit-identical to the sort), ``count3`` and ``band_count`` (equal to
   direct torch counts).
   Then the paper's baselines on the same array (``baselines_path``):
   ``full_sort_quantile``, ``psrs_sort``, ``afs_select`` and
   ``jeffers_select`` at q = 0.5 and 0.99, each equal bit for bit to 4's
   sort oracle (and ``psrs_sort``'s whole output to the stable sort), each
   one's median of BASELINE_RUNS runs after a warm-up, peak memory and the
   count-and-discard rounds, printed beside ``gk_select``'s median (one
   card against one card, not the paper's cluster); then both selects on
   (P, 2^16) arrays whose lowest and highest 2% are the dtype's extremes
   (f32 +-inf, int32 iinfo.min/max) at q in {0, 0.01, 0.99, 1}, each equal
   to a sort within 4 log2 n rounds.
6. Drives the grouped path at the same size: per-tenant latencies
   (lognormal(1.0, 0.6) x (1 + 0.3 tenant), as ``examples/
   grouped_telemetry.py``) with int32 keys over 32 tenants whose traffic
   shares come from Dirichlet(0.5) of ``--seed``;
   ``gk_select_grouped(qs=(0.5, 0.99), num_groups=32, eps=1e-4,
   block_select=True)``, every cell equal bit for bit to a (key, value)
   sort of the whole data on the card.
   Before each of 4-6 every launch count is zeroed, after it the counts are
   read, and every kernel of that path must have launched.  Each prints its
   median wall time of 5 runs after one warm-up, phase times, pass counts,
   peak memory and a torch.profiler breakdown.
7. Drives the streaming service (``repro_torch.QuantileService``, fused).
   ``service_path``: one stream at the paper's size, the main path's array
   ingested as 120 ticks of one 2^23-value row, eps = 1e-4 (budget
   65,536): ``approx(0.5)``, warm ``exact(0.5)`` (no sketch sort, 120
   ``fused_select`` launches), cold ``exact(0.5, warm=False)`` (120 sorts)
   and ``exact_all`` over the 5 levels (120 ``segmented_select``
   launches), each equal bit for bit to 4's sort oracles; then a snapshot
   through ``save_service_snapshot``, whose restored warm ``exact`` is the
   same bits with no sketch sort.  ``tenants_path``: TENANTS = 4096
   telemetry streams over 16 ticks of host batches (lengths 1..4096 from
   ``--seed``, lognormal(1.0, 0.6) x (1 + 0.3 (stream mod 32)) f32), eps =
   0.01: ``exact_all((0.5, 0.99))`` fused (``segmented_select``, one launch
   per 4096 pivots of a record) and row-wise, warm ``exact`` on 8 streams,
   each against one (stream, value) sort of everything; the same ticks
   staged into 4 ``local_buffer()``s and landed by one ``fold_many``
   (``exact_all`` equal to the serial answers); a windowed service (8
   ticks, 4 sub-windows): ``windowed`` over tick and value windows against
   a sort of each window's raw values, ``approx_decayed`` against the CPU
   port on the same state, at most 8 ring records.  Each query runs once
   with every count zeroed just before it (its launches, sketch sorts and
   reads must be the expected ones), then 5 times after a warm-up; each
   path prints phase times, the CUDA kernels and copies of one ingest
   tick (torch.profiler; at S = 1 and S = 4096 for the tenants), peak
   memory and a profiler top list.  The kernels join 2's tally at the
   service's shapes: ``fused_select`` on the 2^23 chunk and on every
   ragged chunk of 4 tenants, ``segmented_select`` on a tick record at
   the service caps (G*Q = 5; 4096 of a tenants record's first 256 rows).
8. Drives the sharded engine (``distributed_quantile(_multi)``,
   ``distributed_quantile_grouped``) over a gloo world of WORLD = 6 ranks,
   each a process on this one card (NCCL refuses two ranks on one device,
   so CUDA tensors cross gloo through host memory), each holding 20 x 2^23
   contiguous values of 4's array and of 6's data, handed over by CUDA IPC:
   ``distributed_quantile(q=0.5, fused=True)`` (fused_select), the faithful
   plan (partition_count), ``distributed_quantile_multi`` over the 5 levels
   cold and warm (fused_select_multi) and the grouped query with
   ``fused=True, check_nans=False`` (segmented_select).  Every answer must
   equal 4's and 6's sort oracles bit for bit, and every rank zeroes its
   launch counts before each query's runs and must find the query's kernel
   launched after them.  Prints each query's median of 5 runs after one
   warm-up, phase times, collective counts and bytes with the host time of
   the copies, and each rank's peak memory.  The ranks then take turns to
   hold fused_select, fused_select_multi, partition_count and
   segmented_select on their own shard, at the path's pivots and cap,
   against the plain versions bit for bit (these cases join 2's tally).
   Then a world of one rank on NCCL answers the 5 levels and the median by
   the PSRS plan (its all_to_all) on one shard with no host copy.  These
   times are of six ranks sharing one card, not of six cards.  The main
   path's array is freed before 6 and made again from ``--seed`` for 7 and
   8, so that 6's peak memory counts 6's data alone.
9. Drives the serving path (``repro_torch.launch.serve``) on granite-8b at
   its published width (36 layers, d_model 4096, 32 heads over 8 KV heads,
   d_ff 14336, vocab 49152; 8.25 B bf16 weights from ``--seed``): 8
   prompts of 512 tokens, 64 greedy tokens each, a KV cache of 576.
   Prints decode after ``prefill(S)`` against ``prefill(S + 1)`` beside the
   JAX test's 5e-2 of the logit scale, and checks that the decode is no
   farther (at most 1.5 x) from an f32 evaluation of the same weights
   than the prefill is; then ``generate`` alone,
   with a fused ``StreamingCalibrator(q=0.999)`` and with a threaded one
   (4 ingest workers), in turns, SERVE_ROUNDS rounds (their median; no
   warm-up round, as the prefill and the decode step have run just
   before), the same tokens each time; a plain (``fused=False``) calibrator takes the last
   round's logits.  Each ``scale`` must equal a sort of
   every observed |logit| (64 ticks of 8 x 49152) bit for bit, and the
   fused ones must launch ``fused_select`` once per ring chunk (counts
   zeroed just before each query).  One-shot: ``calibrate_int8_scale`` over
   the K cache of every layer after ``prefill(S + 1)`` (unwritten slots
   hold zeros) and ``calibrate_int8_scales(axis=-1)`` over the last layer's
   K cache as 4608 x 1024 channels, each against its sort.  Prints prefill,
   decode and tokens/s beside their bounds, calibration per step
   synchronous and threaded, the scale queries' times and launches, peak
   memory and torch.profiler top lists of one decode step and one warm
   ``scale``; ``fused_select`` at the serve's chunk joins 2's tally.
   Last, 8 prompts of 4096 tokens take the blockwise attention: the first
   layer's, against the direct path, within 1e-5 of max |out| and within
   its memory bound (one q block at a time), then the whole prefill.
10. Serves the moe, vlm, ssm, hybrid and audio families the same way
   (``moe_serve_path``, ``vlm_serve_path``, ``ssm_serve_path``,
   ``hybrid_serve_path``, ``audio_serve_path``): olmoe-1b-7b (16 layers,
   d_model 2048, 16 heads of 128, 64 experts of d_ff 1024, top-8, vocab
   50304; 6.92 B bf16 weights), qwen2-vl-2b (28 layers, d_model 1536, 12 heads over 2 KV
   heads of 128, d_ff 8960, vocab 151936, M-RoPE; 1.78 B), mamba2-1.3b (48
   mamba layers, d_model 2048, 64 SSD heads of 64, state 128, vocab 50280)
   and zamba2-2.7b (54 mamba layers, d_model 2560, 80 SSD heads, state 64,
   one shared attention + SwiGLU block of 32 heads of 80 and d_ff 10240
   after every 6, vocab 32000) and seamless-m4t-large-v2 (24 encoder and
   24 decoder layers with cross-attention, d_model 1024, 16 heads of 64,
   d_ff 8192 GELU, vocab 256206; 1.63 B), at their published width and
   depth from ``--seed``: 8 prompts of 512 positions (qwen2-vl's first
   256 are N(0, 1) patch embeddings on a 16 x 16 grid of ``positions3``,
   text j at (j, j, j); seamless's encoder reads 128 N(0, 1) frames a
   prompt, the same for every prompt length), 64 greedy tokens each,
   cache 576 (seamless's cross cache 128).  Decode after
   ``prefill(S)`` against ``prefill(S + 1)`` and each against an f32
   evaluation; the gate of 9 holds over the rows whose last position takes
   the same experts in every layer in decode and prefill(S + 1), for
   olmoe with every expert taking every token (as a decode step's
   capacity does: served, prefill drops assignments and decode does not,
   in the reference too), and the served numbers, the differing expert
   choices (decode vs prefill, bf16 vs f32), the drops and the expert
   loads are printed.  ``generate`` alone and with a fused
   ``StreamingCalibrator``, in turns, SERVE_ROUNDS rounds (as
   ``serve_path``'s), the same tokens each time; the warm ``scale`` over every logit (8 x 64 x vocab
   values) equal to a sort bit for bit, ``fused_select`` launched (every
   count zeroed at the phase's start, read at its end).  For olmoe, the
   first layer's ``moe_block`` on the prefill's 4096 tokens against every
   expert evaluated on every token and picked by the same routing (within
   2e-2 of max |y|), and its router's f32 product against f64 (within
   1e-5); for mamba2 and zamba2, the first mamba layer's chunked scan on
   the prefill's input against the recurrence (within 1e-2 of max |y|).
   Prints times beside bounds, the decode step's busy share, peak
   memory and the phase's seconds; ``fused_select`` at each phase's chunk
   joins 2's tally.
   Then ``swa_serve_path`` serves h2o-danube-1.8b (24 layers, d_model
   2560, 32 heads over 8 KV heads of 80, d_ff 6912 SwiGLU, vocab 32000,
   sliding window 4096; 1.83 B bf16 weights from ``--seed``, the count
   from the tensors) through its ring cache of 4096 slots: (a) 8 prompts
   of SWA_PROMPT = 4064 tokens and 64 greedy tokens (cache_len 4128, so
   the 33rd generated token writes slot 0); decode after ``prefill(S)``
   against ``prefill(S + 1)`` at S = 4064 and, after teacher-forced steps
   through the wrap, at SWA_WRAP_AT = 4100, each against the f32
   evaluation (no cache, every query over its own window) under 9's gate;
   the ring's slots after the steps and after ``generate`` (each slot the
   newest position written there); ``generate`` alone and with a fused
   ``StreamingCalibrator`` in turns, SERVE_ROUNDS rounds, the warm
   ``scale`` over 64 ticks of 8 x 32000 logits equal to a sort bit for
   bit with one ``fused_select`` launch per ring chunk (64; counts zeroed
   at the phase's start); (b) 8 prompts of SWA_LONG_PROMPT = 8192 tokens:
   the first layer's windowed blockwise attention against the direct
   path (1e-5 of max |out|), the prefill's time and peak, the ring after
   ``prefill(8192)`` holding positions 4096..8191 (the reference's quirk:
   earlier queries attend over that cache alone), decode at 8192 against
   ``prefill(8193)`` and f32 under the same gate; (c) ``generate(...,
   greedy=False)`` twice from one seed, ``torch.multinomial`` draws
   from a ``torch.Generator`` (not the JAX package's tokens: the
   generators differ): the same tokens, each in [0, vocab), every decode
   step and draw under ``torch.cuda.set_sync_debug_mode("error")``; (d)
   with the model freed, the windowed blockwise backward on the first
   layer's f32 q, k, v (1 x 8192 x 32 x 80, causal, window 4096) against
   autograd through the direct formula (1e-4 of max |grad|), with its
   peak.  Prints prefill, decode a step and tokens/s of (a) and (b)
   beside bounds that count the ring's 4096 slots, the decode step's busy
   share and the peak memory.
   Then ``deepseek_serve_path`` serves deepseek-coder-33b (62 layers,
   d_model 7168, 56 heads over 8 KV heads of 128, d_ff 19200 SwiGLU,
   vocab 32256; 33.34 B bf16 weights from ``--seed``, 66.7 GB of the
   card's 80) as the families above, nothing cut: the gate of 9 (the f32
   evaluation casts a layer at a time), the gap printed beside 5e-2 and
   beside both packages' CPU readings of its layer stack at 4 and 8
   layers (DECODE_GAP_CPU), the same greedy tokens in each of
   DEEPSEEK_ROUNDS rounds with and without a calibrator, the warm
   ``scale`` over 64 ticks of 8 x 32256 logits against its sort with one
   ``fused_select`` launch per ring chunk; once
   the generates' caches are gone, ``calibrate_int8_scale`` over the
   decode's K cache of all 62 layers (292,552,704 values) against its
   sort, with its launches; the free memory at the phase's start.
11. Drives the training path (``repro_torch.launch.train.train_loop``) on
   stablelm-1.6b at its published width and depth (24 layers, d_model
   2048, 32 heads of 64, d_ff 5632, vocab 100352, LayerNorm with bias;
   1.64 B bf16 parameters from ``--seed``): TRAIN_STEPS steps of 8 x 2048
   Zipf(1.2) tokens, ``remat="nothing_saveable"``, AdamW with the exact
   0.999-quantile clip of |g| (the radix route), then one step with int8
   compression.  Every loss must be finite; every clip threshold and the
   int8 scale must be the exact quantile of what it was taken over (two
   direct int64 counts around the target rank, no code of the radix
   route), and no clipped |g| may exceed its threshold.  Prints step time,
   tokens/s, the model-FLOPs share (6 N T at 989 TFLOP/s), the clip's time
   and share of the step, peak memory, and the busy share and top CUDA
   kernels of one more step.  Then the
   blockwise attention's backward on the first layer's q, k, v (f32, 8 x
   2048 x 32 x 64) against autograd through the direct formula (within
   1e-4 of max |grad|), with its peak memory; and exact resume at 2 layers
   of full width: TRAIN_STEPS steps against half of them, a checkpoint
   (about 5 GB, through a temporary directory) and a restart for the rest,
   the losses within rtol =
   atol = 2e-4 and the restored state equal to the saved one bit for bit.
   The six kernels' launch counts are zeroed before this phase and read
   after it (``train_launches``; the training path launches none).
   Then the other families train the same way (``vlm_train_path``,
   ``audio_train_path``, ``ssm_train_path``, ``hybrid_train_path``,
   ``moe_train_path``): qwen2-vl-2b, seamless-m4t-large-v2, mamba2-1.3b
   and zamba2-2.7b at their published width and depth, olmoe-1b-7b at its
   published width and MOE_TRAIN_LAYERS of its 16 layers (the deepest
   whose run peaks under 72 GB), each FAMILY_TRAIN_STEPS steps of 8 x 2048
   Zipf tokens with the pipeline's patches (256 a row) or frames (512),
   the config's remat, every loss finite and every clip threshold exact
   as above, then one step profiled.  Before the steps, at the seed's
   weights: the bf16 gradients of 2 x 2048 tokens against an f32
   evaluation of the same weights (TF32 off), every leaf of the port's
   tree (one layer's weight) within 3e-2 of its max |g|, or for the
   leaves whose reference misses that on the CPU twice the worst of
   both packages' gaps there (GRAD_GAP_CPU; olmoe's router and
   expert leaves printed beside the expert choices that differ, not
   held), the reference's stacked leaves printed beside, and whether two
   backwards give the same bits.  After them, with the optimizer state
   freed: olmoe's first ``moe_block`` backward on the step's 16,384
   tokens, dropless, against autograd through the direct f32 formula
   (every expert on every token, the same routing), dx and each expert
   weight's gradient within 2e-2 of max |grad|; for seamless the blockwise
   attention's backward at its cross-attention shape (8 x 16 heads of 64,
   2048 queries over 1500 frames, non-causal, so the padded keys' mask
   runs) within 1e-4 of the direct formula.  Each phase prints the
   parameter count from the tensors beside ``cfg.param_count()``, the
   step time beside the model-FLOPs bound (formula and tensors), the
   clip's share, the peak memory, and must launch no kernel.
12. The dry-run tooling (``dryrun_path``): (a) ``python -m
   repro_torch.launch.dryrun --jobs 6`` in a subprocess on fake "cuda"
   tensors (nothing allocated), each of DRYRUN_CELLS at full width in a
   process and fake world of its own (decode, train, a sub-quadratic long
   decode on the 2 x 16 x 16 mesh, a moe decode, a sliding-window
   prefill and a moe train step, whose expert-parallel dispatch must fit
   the card), traced on the host's other cores while (b) runs: every
   record ``ok`` and within the card's 80 GB, its per-chip FLOPs, bytes,
   collective bytes and counts, dominant roofline term and trace seconds
   printed; (b) a real sharded step on the card, an NCCL world of one
   rank and a (1, 1) ("data", "model") mesh: SHARDED_TRAIN's train steps
   at 11's 8 x 2048 with ``distribute_params`` (stablelm-1.6b, and
   olmoe-1b-7b at 2 of its 16 layers: the expert-parallel moe layer's
   exchanges on the card) and granite-8b's prefill and
   one decode step at 9's shapes, each against the plain step on the same
   weights (loss, every gradient, logits: equal bits or the gap, held to
   the CPU tests' bf16 tolerances: loss 1e-4, gradients 3e-2 of max |g|,
   logits 1e-3 of max |logit|), both steps' embedding gradients also held
   to its f32 sum (3e-2), the sharded clip threshold the exact quantile
   of its own |g| (two direct counts, as 11), and both step times, plain
   and sharded (DTensor's host cost), beside the card's name and power
   limit.  No kernel runs on this path.
13. Times each kernel at its path's shapes beside its bound (and the share
   of the peak memory rate it reaches), its plain version and the PyTorch
   calls that compute the same function, and prints one ``kernels`` JSON
   line with all six, each with its launches per
   service query (the serve phases' ``scale`` queries among them,
   ``swa_serve_path``'s 64 ``fused_select`` launches too) and on the
   training path.

Any failure exits non-zero.  The last line is the device record
``{"ok": true, "device": {...}}``; without CUDA, or without the repository
beside it, the script exits non-zero before printing any result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import signal
import statistics
import subprocess
import sys
import tempfile
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
P, N_I, EPS = 120, 1 << 23, 1e-4
QS = (0.01, 0.25, 0.5, 0.75, 0.99)
GROUPS, GROUP_QS = 32, (0.5, 0.99)
TENANTS, TENANT_TICKS, TENANT_LEN = 4096, 16, 4096   # the tenants path
TENANT_EPS, TENANT_QS = 0.01, (0.5, 0.99)
WORLD = 6                          # ranks of the sharded phase, on one card
SERVE_ARCH, SERVE_B, SERVE_PROMPT, SERVE_GEN = "granite-8b", 8, 512, 64
SERVE_Q = 0.999
SERVE_LONG_B, SERVE_LONG_PROMPT = 8, 4096   # prompts for the blockwise path
SERVE_ROUNDS = 1        # timed rounds of generate (their median)
FAMILY_ARCHS = (("moe_serve_path", "olmoe-1b-7b"),
                ("vlm_serve_path", "qwen2-vl-2b"),
                ("ssm_serve_path", "mamba2-1.3b"),
                ("hybrid_serve_path", "zamba2-2.7b"),
                ("audio_serve_path", "seamless-m4t-large-v2"))
# the sliding-window phase (10b): (a)'s prompt, 32 short of the window, so
# that the 33rd generated token wraps the ring; the teacher-forced position
# past the wrap where decode is gated again; (b)'s prompt past the window
SWA_ARCH = "h2o-danube-1.8b"
SWA_PROMPT, SWA_WRAP_AT, SWA_LONG_PROMPT = 4064, 4100, 8192
# the configuration whose bf16 weights fill the card (10c), and the bf16
# decode gap of its layer stack in both packages on the CPU at its own
# widths, cut to 4 and 8 of its 62 layers (tests/_decode_gap.py
# family_gaps, B = 2, S = 64; ROADMAP.md Queue 3 item 3), printed beside
# the card's
DEEPSEEK_ARCH, DEEPSEEK_ROUNDS = "deepseek-coder-33b", 2
DECODE_GAP_CPU = {DEEPSEEK_ARCH: {
    "4_layers": {"jax": {"gap": 0.01622, "decode_vs_f32": 0.03041,
                         "prefill_vs_f32": 0.02895},
                 "port": {"gap": 0.01942, "decode_vs_f32": 0.0284,
                          "prefill_vs_f32": 0.02663}},
    "8_layers": {"jax": {"gap": 0.03137, "decode_vs_f32": 0.04286,
                         "prefill_vs_f32": 0.04169},
                 "port": {"gap": 0.02621, "decode_vs_f32": 0.04114,
                          "prefill_vs_f32": 0.0394}}}}
TRAIN_ARCH, TRAIN_B, TRAIN_S, TRAIN_STEPS = "stablelm-1.6b", 8, 2048, 2
TRAIN_Q, TRAIN_RESUME_LAYERS = 0.999, 2
# the train phases of the other families (11b): steps, olmoe-1b-7b's cut
# depth (the deepest whose run peaks under 72 GB), the rows and tolerance
# of the gradient gate against f32, the moe backward's tolerance and the
# experts its f32 formula takes at a time, and the cross-attention shape
# of the flash backward check (B, heads, d_head, Sq, Sk frames)
FAMILY_TRAIN_ARCHS = (("vlm_train_path", "qwen2-vl-2b"),
                      ("audio_train_path", "seamless-m4t-large-v2"),
                      ("ssm_train_path", "mamba2-1.3b"),
                      ("hybrid_train_path", "zamba2-2.7b"),
                      ("moe_train_path", "olmoe-1b-7b"))
FAMILY_TRAIN_STEPS, MOE_TRAIN_LAYERS = 2, 10
GRAD_B, GRAD_TOL = 2, 3e-2
# where the reference's own bf16 gradient misses GRAD_TOL of its f32
# evaluation on the CPU at the seed's weights, a layer at a time:
# {arch: {the reference's leaf: (JAX's worst layer, the port's)}} from
# tests/_grad_gap.py --steps 0 --seq 512 at d_model 256 and the card's
# depth (ROADMAP.md Queue 3 item 13).  That leaf's layers are held at
# twice the larger of the two; olmoe's routed leaves are not held.
GRAD_GAP_CPU = {
    "qwen2-vl-2b": {"['embed']": (0.0364, 0.0346)},
    "olmoe-1b-7b": {"['blocks']['ln2']": (0.0569, 0.0392),
                    "['embed']": (0.0520, 0.0520)},
    "mamba2-1.3b": {"['blocks']['A_log']": (0.3482, 0.1671),
                    "['blocks']['dt_bias']": (0.3240, 0.1642),
                    "['blocks']['D']": (0.1405, 0.1396),
                    "['blocks']['out_norm']": (0.1005, 0.0828),
                    "['blocks']['conv_w']": (0.0828, 0.0925),
                    "['blocks']['norm']": (0.0911, 0.0786),
                    "['blocks']['conv_b']": (0.0899, 0.0760),
                    "['blocks']['in_proj']": (0.0875, 0.0766),
                    "['blocks']['out_proj']": (0.0817, 0.0768),
                    "['embed']": (0.0790, 0.0527),
                    "['head']": (0.0403, 0.0355),
                    "['final_norm']": (0.0383, 0.0294)},
    "zamba2-2.7b": {"['mamba']['A_log']": (0.3057, 0.2150),
                    "['mamba']['dt_bias']": (0.2387, 0.1792),
                    "['mamba']['D']": (0.1751, 0.1893),
                    "['mamba']['out_norm']": (0.1510, 0.1041),
                    "['mamba']['norm']": (0.1154, 0.0979),
                    "['mamba']['conv_w']": (0.1042, 0.0940),
                    "['mamba']['in_proj']": (0.0946, 0.0990),
                    "['mamba']['out_proj']": (0.0892, 0.0936),
                    "['mamba']['conv_b']": (0.0878, 0.0753),
                    "['shared']['ln2']": (0.0869, 0.0588),
                    "['shared']['wk']": (0.0862, 0.0715),
                    "['embed']": (0.0821, 0.0560),
                    "['shared']['w_gate']": (0.0677, 0.0636),
                    "['shared']['w_down']": (0.0630, 0.0638),
                    "['shared']['w_up']": (0.0631, 0.0621),
                    "['shared']['wq']": (0.0627, 0.0608),
                    "['shared']['ln1']": (0.0552, 0.0450),
                    "['head']": (0.0387, 0.0327),
                    "['shared']['wv']": (0.0341, 0.0298),
                    "['final_norm']": (0.0338, 0.0305)},
}
MOE_GRAD_TOL, MOE_FORMULA_EXPERTS = 2e-2, 8
CROSS_FLASH = (8, 16, 64, 2048, 1500)
# the dry-run cells of phase 12 (arch, shape, mesh): decode, train, a long
# decode on 2 x 16 x 16, a moe decode, a sliding-window prefill (the
# cheapest full-width prefill to trace) and a moe train step (the
# expert-parallel dispatch, within the card)
DRYRUN_CELLS = (("granite-8b", "decode_32k", "pod1"),
                ("stablelm-1.6b", "train_4k", "pod1"),
                ("mamba2-1.3b", "long_500k", "pod2"),
                ("olmoe-1b-7b", "decode_32k", "pod1"),
                ("h2o-danube-1.8b", "prefill_32k", "pod1"),
                ("olmoe-1b-7b", "train_4k", "pod1"))
# the sharded train steps of phase 12 (arch, layers; None: all of them):
# the dense one, and olmoe-1b-7b's at 2 of its 16 layers (the
# expert-parallel moe layer on the card)
SHARDED_TRAIN = (("stablelm-1.6b", None), ("olmoe-1b-7b", 2))
DRYRUN_LIMIT_S = 600
TIMED_RUNS = 5
BASELINE_RUNS = 2       # timed runs of each baseline after its warm-up
DTYPES = (torch.float32, torch.bfloat16, torch.int32, torch.float64)
U32_DTYPES = (torch.float32, torch.bfloat16, torch.int32)
CSRC = "src/repro_torch/kernels/csrc/"
SOURCES = {"fused_select": "fused_select.cu",
           "fused_select_multi": "fused_select.cu",
           "partition_count": "partition_count.cu",
           "segmented_select": "segmented_select.cu",
           "byte_histogram": "byte_histogram.cu",
           "band_count": "band_count.cu"}
REPLACES = {"fused_select": "src/repro/kernels/fused_select.py:119",
            "fused_select_multi": "src/repro/kernels/fused_select.py:207",
            "partition_count": "src/repro/kernels/partition_count.py:86",
            "segmented_select": "src/repro/kernels/segmented_select.py:86",
            "byte_histogram": "src/repro/kernels/fused_select.py:289",
            "band_count": "src/repro/kernels/band_count.py:46"}


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


def _profile(fn, top: int = 8, warm: bool = True) -> dict:
    """Device time by kernel (and memcpy, memset) over one call of fn after
    a warm-up call (none where ``warm`` is False: fn ran before), from
    torch.profiler's Chrome trace (its event list's Python objects take
    minutes for a call of ~10^5 launches), and the device's busy share of
    the call's wall time."""
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    if warm:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    by_name, launches = {}, 0
    for evt in events:
        if evt.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        launches += evt["cat"] == "kernel"
        name = evt["name"].replace("(anonymous namespace)::", "")
        name = name.replace("void ", "").split("<")[0].split("(")[0]
        name = name.split("::")[-1].strip()
        by_name[name] = by_name.get(name, 0.0) + evt.get("dur", 0) / 1e3
    device_ms = sum(by_name.values())
    if not device_ms:
        return {"wall_ms": wall * 1e3, "device_ms": "not measured"}
    return {"wall_ms": wall * 1e3, "device_ms": device_ms,
            "kernel_launches": launches,
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
    if kind == "nans":                      # floats only
        x = _case_data(dtype, "sentinels", shape, gen)
        flat = x.view(-1)
        pos, neg = _nans(dtype)
        flat[::5] = pos
        flat[2::9] = neg
        flat[4::13] = -0.0
        flat[6::13] = 0.0
        return x
    raise ValueError(kind)


def _nans(dtype) -> torch.Tensor:
    """(+NaN, -NaN) of a float dtype on the card, bit for bit."""
    from repro_torch.testing import nans
    return nans(dtype, "cuda")


def _pivots_for(x: torch.Tensor):
    flat = x.reshape(-1)
    if x.dtype.is_floating_point:
        flat = flat[~torch.isnan(flat)]
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
    picks = torch.stack([p.to(x.dtype).cuda() for p in picks])
    if x.dtype.is_floating_point and bool(torch.isnan(x).any()):
        picks = torch.cat([picks, _nans(x.dtype)])      # NaN pivots
    return picks


class Tally:
    """passed/total per kernel over the parity cases."""

    def __init__(self):
        self.passed, self.total = {}, {}

    def add(self, name: str, ok: bool, what: str) -> None:
        self.total[name] = self.total.get(name, 0) + 1
        self.passed[name] = self.passed.get(name, 0) + int(ok)
        if not ok:
            print(f"MISMATCH {name} {what}", flush=True)

    def result(self) -> dict:
        return {name: (self.passed[name], self.total[name])
                for name in self.total}


def fused_parity(tally) -> None:
    """Every case through both fused kernels and both plain versions."""
    from repro_torch.kernels import fused_select as fs, ref
    gen = torch.Generator(device="cuda").manual_seed(1234)
    cases = [("normal", (3, 1000), [1, 50, 1000]),
             ("normal", (2, 1001), [7, 1001]),
             ("normal", (1, 7), [1, 3, 7]),
             ("normal", (2, 300_001), [5000]),
             ("all_equal", (2, 4096), [16, 4096]),
             ("ties", (3, 20_000), [2000]),
             ("signed_zeros", (2, 3001), [40, 3001]),
             ("sentinels", (2, 5000), [100, 5000]),
             ("nans", (2, 5001), [100, 5001])]
    for dtype in DTYPES:
        for kind, shape, caps in cases:
            if kind == "nans" and not dtype.is_floating_point:
                continue
            x = _case_data(dtype, kind, shape, gen)
            pivots = _pivots_for(x)
            if kind == "signed_zeros" and dtype.is_floating_point:
                pivots = torch.cat([pivots, torch.tensor(
                    [-0.0, 0.0, -1.0, 1.0], device="cuda").to(dtype)])
            for cap in caps:
                for i in range(pivots.numel()):
                    got = fs.fused_select(x, pivots[i], cap)
                    want = ref.fused_select_ref(x, pivots[i], cap)
                    tally.add("fused_select", _same_bits(got, want),
                              f"{dtype} {kind} {shape} cap={cap} pivot#{i}")
                # duplicate pivots and more than one launch's worth
                multi = torch.cat([pivots, pivots[:3]])
                got = fs.fused_select_multi(x, multi, cap)
                want = ref.fused_select_multi_ref(x, multi, cap)
                tally.add("fused_select_multi", _same_bits(got, want),
                          f"{dtype} {kind} {shape} cap={cap}")
    torch.cuda.synchronize()


def _wide_fused_case(dtype, kind: str, gen):
    """(2, 2^20) data whose bands, at caps 40,000 and 150,000, take 1 to 10
    runs of the band sort (T = 65,536, 32,768 or 16,384 keys for 2-, 4- and
    8-byte keys), some trimmed and some whole; kind "zeros" makes a tenth
    of the values ties across run boundaries: both zeros, the subnormals
    +-tiny (in the canonical bin of 0.0 and the one below it) and 1.0
    (int32: 0, +-1 and 5).  Pivots: ``_pivots_for``'s and +-tiny, 1.0 (+-1
    for int32), so that +-0.0 share a canonical bin with their
    neighbours."""
    shape = (2, 1 << 20)
    x = _case_data(dtype, "normal", shape, gen)
    ints = dtype == torch.int32
    tiny = 1e-310 if dtype == torch.float64 else 1e-40
    table = torch.tensor([0.0, 0.0, 1.0, -1.0, 5.0] if ints
                         else [-0.0, 0.0, tiny, -tiny, 1.0],
                         dtype=torch.float64, device="cuda").to(dtype)
    if kind == "zeros":
        flat = x.view(-1)
        tie = torch.rand(flat.shape, generator=gen, device="cuda") < 0.1
        pick = torch.randint(0, table.numel(), flat.shape, generator=gen,
                             device="cuda")
        flat[tie] = table[pick[tie]]
    pivots = torch.cat([_pivots_for(x), table[2:4] if ints else table[2:]])
    return x, pivots


def fused_wide_parity(tally) -> None:
    """Both fused kernels on bands wider than one run of the band sort,
    against their plain versions: ``_wide_fused_case`` on every dtype,
    each pivot alone and all of them with three repeated (two multi
    launches)."""
    from repro_torch.kernels import fused_select as fs, ref
    gen = torch.Generator(device="cuda").manual_seed(2345)
    for dtype in DTYPES:
        for kind in ("normal", "zeros"):
            x, pivots = _wide_fused_case(dtype, kind, gen)
            multi = torch.cat([pivots, pivots[:3]])
            for cap in (40_000, 150_000):
                for i in range(pivots.numel()):
                    got = fs.fused_select(x, pivots[i], cap)
                    want = ref.fused_select_ref(x, pivots[i], cap)
                    tally.add("fused_select", _same_bits(got, want),
                              f"wide {dtype} {kind} cap={cap} pivot#{i}")
                got = fs.fused_select_multi(x, multi, cap)
                want = ref.fused_select_multi_ref(x, multi, cap)
                tally.add("fused_select_multi", _same_bits(got, want),
                          f"wide {dtype} {kind} cap={cap}")
    torch.cuda.synchronize()


COUNT_CASES = [("normal", (1000,)), ("normal", (1001,)), ("normal", (7,)),
               ("normal", (300_001,)), ("all_equal", (4096,)),
               ("ties", (20_000,)), ("signed_zeros", (3001,)),
               ("sentinels", (5000,))]


def counting_parity(tally: Tally) -> None:
    """partition_count (values and sortable domain, and the 32-step search),
    band_count and byte_histogram (and the 4-pass walk) against their plain
    versions."""
    from repro_torch.kernels import band_count as bc, fused_select as fs
    from repro_torch.kernels import partition_count as pc, ref
    gen = torch.Generator(device="cuda").manual_seed(4321)
    for dtype in DTYPES:
        for kind, shape in COUNT_CASES:
            x = _case_data(dtype, kind, shape, gen)
            pool = _pivots_for(x)
            for i in range(pool.numel()):
                got = pc.partition_count(x, pool[i])
                want = ref.partition_count_ref(x, pool[i])
                tally.add("partition_count", _same_bits([got], [want]),
                          f"{dtype} {kind} {shape} pivot#{i}")
                for j in (0, pool.numel() - 1 - i):
                    got = bc.band_count(x, pool[i], pool[j])
                    want = ref.band_count_ref(x, pool[i], pool[j])
                    tally.add("band_count", _same_bits([got], [want]),
                              f"{dtype} {kind} {shape} band#{i},{j}")
            if dtype not in U32_DTYPES:
                continue
            u = ref.to_sortable_u32(x)
            w = ref.u32_as_int64(u)
            n = x.numel()
            for t in (0, int(w[n // 2]), int(w.min()), int(w.max()),
                      0xFFFFFFFF):
                got = pc.partition_count(u, t)
                want = ref.partition_count_ref(w, t)
                tally.add("partition_count", _same_bits([got], [want]),
                          f"u32 of {dtype} {kind} {shape} t={t}")
            top = int(w[n // 3])
            for prefix, mask, shift in ((0, 0, 24),
                                        (top & 0xFF000000, 0xFF000000, 16),
                                        (top & 0xFFFF0000, 0xFFFF0000, 8),
                                        (top & 0xFFFFFF00, 0xFFFFFF00, 0)):
                want = ref.byte_histogram_ref(u, prefix, mask, shift)
                for src in (x, u):
                    got = fs.byte_histogram(src, prefix, mask, shift)
                    tally.add("byte_histogram", _same_bits([got], [want]),
                              f"{src.dtype} of {dtype} {kind} {shape} "
                              f"shift={shift}")
            for k in (0, 1, n // 2, n, n + 1):
                tally.add("byte_histogram", _same_bits(
                    [fs.radix_walk(x, k)], [ref.radix_walk_ref(u, k)]),
                    f"radix walk {dtype} {kind} {shape} k={k}")
                tally.add("partition_count", _same_bits(
                    [pc.bisect(x, k)], [ref.bisect_ref(u, k)]),
                    f"bisect {dtype} {kind} {shape} k={k}")
    torch.cuda.synchronize()


def _group_keys(kind: str, shape, G: int, gen) -> torch.Tensor:
    if kind == "one":                       # one group holds all the data
        return torch.zeros(shape, dtype=torch.int32, device="cuda")
    k = torch.randint(-1, G + 1, shape, generator=gen, device="cuda",
                      dtype=torch.int32)    # -1 and G belong to no group
    if kind == "empty":                     # group 1 holds nothing
        k = torch.where(k == 1, torch.full_like(k, G), k)
    return k


def _pivot_grids(x: torch.Tensor, keys: torch.Tensor, G: int, Q: int):
    """A grid cycling through the edge pivots, and one of each group's own
    quantiles (the pool's middle value for an empty group)."""
    pool = _pivots_for(x)
    if x.dtype.is_floating_point:
        pool = torch.cat([pool, torch.tensor([-0.0, 0.0], device="cuda")
                          .to(x.dtype)])
    cyc = pool[torch.arange(G * Q, device="cuda") % pool.numel()]
    own = []
    for g in range(G):
        mine = x[keys == g]
        if x.dtype.is_floating_point:
            mine = mine[~torch.isnan(mine)]
        mine = torch.sort(mine.double()).values
        for q in range(Q):
            own.append(mine[(q + 1) * (mine.numel() - 1) // (Q + 1)]
                       if mine.numel() else pool[0].double())
    return [cyc.reshape(G, Q), torch.stack(own).to(x.dtype).reshape(G, Q)]


SEGMENTED_CASES = [
    # data, shape, G, Q, keys, caps
    ("normal", (3, 1000), 5, 3, "spread", [1, 37, 1000]),
    ("normal", (2, 1001), 4, 2, "empty", [7, 1001]),
    ("normal", (1, 7), 2, 2, "spread", [1, 7]),
    ("normal", (2, 300_001), 6, 2, "spread", [5000]),
    ("all_equal", (2, 4096), 3, 2, "spread", [16, 4096]),
    ("ties", (3, 20_000), 4, 2, "spread", [2000]),
    ("signed_zeros", (2, 3001), 3, 3, "spread", [40, 3001]),
    ("sentinels", (2, 5000), 3, 2, "spread", [100, 5000]),
    ("normal", (2, 5000), 1, 1, "one", [64, 5000]),           # G*Q = 1
    ("normal", (2, 20_000), 100, 2, "spread", [50]),   # histograms in 2 slices
    ("nans", (2, 5001), 3, 4, "spread", [100, 5001]),  # floats only
]


def segmented_parity(tally: Tally) -> None:
    """segmented_select against its plain version, all three outputs."""
    from repro_torch.kernels import ref, segmented_select as ss
    gen = torch.Generator(device="cuda").manual_seed(2468)
    for dtype in DTYPES:
        for kind, shape, G, Q, key_kind, caps in SEGMENTED_CASES:
            if kind == "nans" and not dtype.is_floating_point:
                continue
            x = _case_data(dtype, kind, shape, gen)
            keys = _group_keys(key_kind, shape, G, gen)
            for gi, grid in enumerate(_pivot_grids(x, keys, G, Q)):
                for cap in caps:
                    got = ss.segmented_select(x, keys, grid, cap)
                    want = ref.segmented_select_ref(x, keys, grid, cap)
                    tally.add("segmented_select", _same_bits(got, want),
                              f"{dtype} {kind} {shape} G={G} Q={Q} "
                              f"{key_kind} grid#{gi} cap={cap}")
    torch.cuda.synchronize()


def _wide_case(dtype, kind: str, tile: int, gen):
    """(2, n) data and keys whose groups hold the band widths that reach
    the merge passes: 1, T - 1, T, T + 1, 2T + 3 (3 runs), 3T + 5 and
    4T + 1 or 2^17 + 7, whichever is larger (5 or 9 runs), plus 1000
    elements of no group; T is the run tile.  Pivots per group: below all
    of its data, its median, above all of it."""
    sizes = [1, tile - 1, tile, tile + 1, 2 * tile + 3, 3 * tile + 5,
             max(4 * tile + 1, (1 << 17) + 7)]
    G = len(sizes)
    base = torch.repeat_interleave(
        torch.arange(-1, G, device="cuda", dtype=torch.int32),
        torch.tensor([1000] + sizes, device="cuda"))
    n = base.numel()
    keys = torch.stack([base[torch.randperm(n, generator=gen, device="cuda")]
                        for _ in range(2)])
    x = _case_data(dtype, kind, (2, n), gen)
    lo, hi = ((float("-inf"), float("inf")) if dtype.is_floating_point
              else (torch.iinfo(dtype).min, torch.iinfo(dtype).max))
    grid = []
    for g in range(G):
        mine = torch.sort(x[keys == g].double()).values
        grid.append([lo, float(mine[(mine.numel() - 1) // 2]), hi])
    pivots = torch.tensor(grid, dtype=torch.float64, device="cuda").to(dtype)
    return x, keys, pivots, sizes


def segmented_wide_parity(tally: Tally) -> None:
    """segmented_select on bands wider than one run of its sort: every
    band width of ``_wide_case`` kept whole (cap = the widest), an overfull
    band the trim cuts (cap = 3T + 1) and bands of T - 3 kept keys, on
    normal data and on signed zeros and ties that straddle run
    boundaries."""
    from repro_torch.kernels import ref, segmented_select as ss
    gen = torch.Generator(device="cuda").manual_seed(1357)
    for dtype in DTYPES:
        tile = ss.run_tile(dtype)
        for kind in ("normal", "signed_zeros"):
            x, keys, pivots, sizes = _wide_case(dtype, kind, tile, gen)
            for cap in (max(sizes), 3 * tile + 1, tile - 3):
                got = ss.segmented_select(x, keys, pivots, cap)
                want = ref.segmented_select_ref(x, keys, pivots, cap)
                tally.add("segmented_select", _same_bits(got, want),
                          f"wide {dtype} {kind} T={tile} cap={cap}")
    torch.cuda.synchronize()


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
    # the grouped path: both argsorts, the masked first-minimum argmin, the
    # segmented kernel and the resolve sorts on zeros and ties
    from repro_torch.core import gk_select_grouped
    from repro_torch.core.grouped import query_grouped_sketch
    for kind in ("signed_zeros", "ties"):
        x = _case_data(torch.float32, kind, (4, 2000), gen)
        keys = torch.randint(-1, 6, (4, 2000), generator=gen, device="cuda",
                             dtype=torch.int32)
        for bs in (False, True):
            got = gk_select_grouped(x, keys, (0.1, 0.3, 0.5, 0.9),
                                    num_groups=5, eps=0.05, block_select=bs)
            want = gk_select_grouped(x.cpu(), keys.cpu(), (0.1, 0.3, 0.5, 0.9),
                                     num_groups=5, eps=0.05)
            bad += not torch.equal(_bits(got.cpu()), _bits(want))
    # argmin ties: estimates 2, 4, 6, ... against odd ranks tie two lanes;
    # the first one must win on the card as on the CPU
    vals = torch.arange(64, dtype=torch.float32).reshape(2, 32)
    wts = torch.full((2, 32), 2, dtype=torch.int32)
    ks = torch.tensor([[1, 3, 33], [5, 63, 64]], dtype=torch.int32)
    slack = torch.zeros(2, dtype=torch.int32)
    want = query_grouped_sketch(vals, wts, slack, ks)
    got = query_grouped_sketch(vals.cuda(), wts.cuda(), slack.cuda(), ks.cuda())
    first = torch.tensor([[0.0, 0.0, 15.0], [33.0, 62.0, 63.0]])
    bad += not (torch.equal(got.cpu(), want) and torch.equal(want, first))
    return bad


# ---------------------------------------------------------------------------
# 3. main path
# ---------------------------------------------------------------------------


def _main_data(seed: int) -> torch.Tensor:
    """The main path's (P, N_I) float32 normal values from ``seed``; the
    same bits on every call."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn((P, N_I), generator=gen, device="cuda",
                       dtype=torch.float32)


def main_path(seed: int) -> dict:
    from repro_torch.core import gk_select, gk_select_multi, local_ops
    from repro_torch.core.sketch import (local_sample_sketch,
                                         query_merged_sketch,
                                         sample_sketch_params)
    from repro_torch.kernels import fused_select as fs, ops, ref

    x = _main_data(seed)
    n = x.numel()
    k_single = local_ops.target_rank(n, 0.5)
    ks = [local_ops.target_rank(n, q) for q in QS]

    # oracle: one sort of the whole array on the card
    srt = torch.sort(x.reshape(-1)).values
    want_single = srt[k_single - 1].clone()
    want_multi = srt[torch.tensor(ks, device="cuda") - 1].clone()
    del srt
    torch.cuda.empty_cache()

    import repro_torch.kernels as K
    K.reset_launches()
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
    main_launches = K.launches()
    peak = torch.cuda.max_memory_allocated()

    if not torch.equal(_bits(got_single), _bits(want_single)):
        raise AssertionError(f"gk_select: {got_single} != oracle {want_single}")
    if not torch.equal(_bits(got_multi), _bits(want_multi)):
        raise AssertionError(f"gk_select_multi: {got_multi} != {want_multi}")
    for name in ("fused_select", "fused_select_multi"):
        if main_launches[name] < 1:
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

    kernels = [
        _kernel_row("fused_select", main_launches["fused_select"],
                    lambda: fs.fused_select(x, pivot, cap),
                    lambda: ref.fused_select_ref(x, pivot, cap),
                    lambda: _library_bands(x, pivot, cap),
                    "per pivot: torch.topk of the shards masked below and "
                    "above it (both bands), (x < p).sum(-1), (x == p).sum(-1)",
                    x.numel() * 4 + P * (3 * 4 + 2 * cap * 4)),
        _kernel_row("fused_select_multi", main_launches["fused_select_multi"],
                    lambda: fs.fused_select_multi(x, pivots, cap),
                    lambda: ref.fused_select_multi_ref(x, pivots, cap),
                    lambda: _library_bands(x, pivots, cap),
                    "the same calls for each of the 5 pivots",
                    x.numel() * 4 + len(QS) * P * (3 * 4 + 2 * cap * 4)),
    ]
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
    }, (x, pivots, want_single, want_multi, k_single)


def _library_bands(x, pivots, cap):
    """PyTorch calls that compute fused_select's function for each pivot."""
    lo = torch.tensor(float("-inf"), device=x.device, dtype=x.dtype)
    hi = torch.tensor(float("inf"), device=x.device, dtype=x.dtype)
    out = []
    for p in pivots.reshape(-1):
        out.append((torch.topk(torch.where(x < p, x, lo), cap, dim=-1).values,
                    torch.topk(torch.where(x > p, x, hi), cap, dim=-1,
                               largest=False).values,
                    (x < p).sum(-1), (x == p).sum(-1)))
    return out


def _kernel_row(name, launches, kernel, plain, library, library_call,
                moved_bytes, plain_iters=2) -> dict:
    """One kernel at its path's shapes: parity with its plain version on
    these inputs, its time, the plain version's, the library calls', the
    bound (each input byte read once, each output byte written once) and
    the share of the peak memory rate that its time reaches."""
    from repro_torch.launch import roofline
    got, want = kernel(), plain()
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    if not _same_bits(got, want):
        raise AssertionError(f"{name} differs from its plain version at the "
                             f"path's shapes")
    err = _max_abs_err(got, want)
    del got, want
    torch.cuda.empty_cache()
    row = {"name": name, "route": "cuda", "source": CSRC + SOURCES[name],
           "replaces": REPLACES[name], "launches": launches,
           "max_abs_err": err, "ms": _event_ms(kernel, 5),
           "plain_ms": _event_ms(plain, plain_iters),
           "bound_ms": moved_bytes / roofline.HBM_BW * 1e3,
           "bound_by": "bytes",
           "library_ms": None if library is None
           else _event_ms(library, plain_iters),
           "library_call": library_call}
    row["frac_of_peak_bw"] = roofline.kernel_roofline(
        moved_bytes, row["ms"] / 1e3, "cuda")["frac_of_peak"]
    torch.cuda.empty_cache()
    return row


def _median_s(fn, runs: int = TIMED_RUNS) -> tuple:
    """(last result, median seconds of ``runs`` runs after one warm-up)."""
    out, times = None, []
    for _ in range(runs + 1):
        out, t = _sync_time(fn)
        times.append(t)
    return out, statistics.median(times[1:])


# ---------------------------------------------------------------------------
# 5. counting and radix entry points on the main path's array
# ---------------------------------------------------------------------------


def counting_path(x, pivots, want, k) -> dict:
    import repro_torch.kernels as K
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import (band_count as bc, fused_select as fs,
                                     partition_count as pc)
    p, lo, hi = pivots[2], pivots[1], pivots[3]        # q = 0.5, 0.25, 0.75
    flat = x.reshape(-1)

    # each entry point alone, its launch counts zeroed just before it
    calls = {"radix_select_kth": (lambda: ops.radix_select_kth(x, k),
                                  {"byte_histogram": 4}),
             "radix_select_kth_bitwise": (
                 lambda: ops.radix_select_kth_bitwise(x, k),
                 {"partition_count": 32}),
             "count3": (lambda: ops.count3(x, p), {"partition_count": 1}),
             "band_count": (lambda: ops.band_count(x, lo, hi),
                            {"band_count": 1})}
    got, launched = {}, {}
    for name, (fn, expect) in calls.items():
        K.reset_launches()
        got[name] = fn()
        torch.cuda.synchronize()
        launched[name] = {kn: c for kn, c in K.launches().items() if c}
        if launched[name] != expect:
            raise AssertionError(f"{name} launched {launched[name]}, "
                                 f"expected {expect}")
    for name in ("radix_select_kth", "radix_select_kth_bitwise"):
        if not torch.equal(_bits(got[name]), _bits(want)):
            raise AssertionError(f"{name}: {got[name]} != oracle {want}")
    direct = torch.stack([(flat < p).sum(), (flat == p).sum(), (flat > p).sum()])
    if not torch.equal(got["count3"].long(), direct):
        raise AssertionError(f"count3 {got['count3']} != {direct}")
    if int(got["band_count"]) != int(((flat > lo) & (flat < hi)).sum()):
        raise AssertionError("band_count differs from the direct count")

    passes = {}
    for name, fn in (("radix_select_kth", lambda: ops.radix_select_kth(x, k)),
                     ("radix_select_kth_bitwise",
                      lambda: ops.radix_select_kth_bitwise(x, k))):
        ops.reset_hbm_passes()
        fn()
        passes[name] = ops.hbm_passes()
    medians = {name + "_median_s": _median_s(fn)[1]
               for name, (fn, _) in calls.items()}

    n = x.numel()
    kernels = [
        _kernel_row("partition_count",
                    launched["radix_select_kth_bitwise"]["partition_count"],
                    lambda: pc.partition_count(x, p),
                    lambda: ref.partition_count_ref(flat, p),
                    lambda: ((flat < p).sum(), (flat == p).sum()),
                    "(x < p).sum(), (x == p).sum()", n * 4 + 12),
        _kernel_row("band_count", launched["band_count"]["band_count"],
                    lambda: bc.band_count(x, lo, hi),
                    lambda: ref.band_count_ref(flat, lo, hi),
                    lambda: ((flat > lo) & (flat < hi)).sum(),
                    "((x > lo) & (x < hi)).sum()", n * 4 + 4),
        _kernel_row("byte_histogram",
                    launched["radix_select_kth"]["byte_histogram"],
                    lambda: fs.byte_histogram(x, 0, 0, 24),
                    lambda: ref.byte_histogram_ref(ref.to_sortable_u32(x), 0,
                                                   0, 24),
                    lambda: torch.bincount(
                        (ref.to_sortable_u32(flat).view(torch.int32) >> 24)
                        & 0xFF, minlength=256),
                    "torch.bincount of the top byte of to_sortable_u32(x) "
                    "(prefix and mask 0: every element matches)",
                    n * 4 + 256 * 4),
    ]
    return {"launches": launched, "passes": passes, **medians,
            "answer": float(got["radix_select_kth"]),
            "count3": got["count3"].tolist(),
            "band_count": int(got["band_count"])}, kernels


# ---------------------------------------------------------------------------
# 5b. the paper's baselines on the main path's array
# ---------------------------------------------------------------------------


def _extreme_data(dtype, seed: int) -> torch.Tensor:
    """(P, 2^16) values whose lowest and highest 2% are the dtype's
    extremes (-inf/+inf for float32, iinfo.min/max for int32), the rest
    normal (float32) or in [-100, 100) (int32), shuffled."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    n = P << 16
    if dtype == torch.float32:
        x = torch.randn(n, generator=gen, device="cuda")
        lo, hi = float("-inf"), float("inf")
    else:
        x = torch.randint(-100, 100, (n,), generator=gen, device="cuda",
                          dtype=torch.int32)
        info = torch.iinfo(torch.int32)
        lo, hi = info.min, info.max
    m = n // 50
    x[:m], x[m:2 * m] = lo, hi
    return x[torch.randperm(n, generator=gen, device="cuda")].reshape(P, -1)


def baselines_path(x, want_multi, gk_median_s: float) -> dict:
    """The paper's comparison suite (§IV) on the main path's array:
    ``full_sort_quantile``, ``psrs_sort``, ``afs_select`` and
    ``jeffers_select`` at q = 0.5 and 0.99, each equal bit for bit to the
    main path's sort oracle, and ``psrs_sort``'s output equal to the stable
    sort element for element; each one's median of BASELINE_RUNS after a
    warm-up, its peak memory, the count-and-discard rounds, and the full
    sort beside ``gk_select``.  Then the count-and-discard selects at the
    dtype extremes, each equal to a sort.  The baselines launch none of
    the six kernels (the reference's count is a plain ``jnp`` pass)."""
    import repro_torch.kernels as K
    from repro_torch.core import baselines as bl, local_ops

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    K.reset_launches()
    qs = (0.5, 0.99)
    wants = {q: want_multi[QS.index(q)] for q in qs}
    n = x.numel()
    out = {"n": n, "shards": P, "answers": {}, "median_s": {},
           "runs_s": {}, "peak_above_data_bytes": {}, "rounds": {}}

    def timed(name, fn):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        times, got = [], None
        for _ in range(BASELINE_RUNS + 1):
            got = None                       # free the last result first
            got, t = _sync_time(fn)
            times.append(t)
        out["runs_s"][name] = times[1:]
        out["median_s"][name] = statistics.median(times[1:])
        out["peak_above_data_bytes"][name] = (
            torch.cuda.max_memory_allocated() - base)
        return got

    selects = (("full_sort_quantile", bl.full_sort_quantile, None),
               ("afs_select", bl.afs_select, 0),
               ("jeffers_select", bl.jeffers_select, 1))
    for name, fn, seed in selects:
        for q in qs:
            got = timed(f"{name}_q{q}", lambda: fn(x, q))
            _check_bits(f"{name} q={q}", got, wants[q])
            out["answers"][f"{name}_q{q}"] = float(got)
            if seed is not None:
                out["rounds"][f"{name}_q{q}"] = bl.count_discard_rounds(
                    x, q, seed=seed)
    srt = timed("psrs_sort", lambda: bl.psrs_sort(x))
    for q in qs:
        _check_bits(f"psrs_sort q={q}",
                    srt[local_ops.target_rank(n, q) - 1], wants[q])
    oracle = local_ops.stable_sort(x.reshape(-1))
    if not torch.equal(_bits(srt), _bits(oracle)):
        raise AssertionError("psrs_sort differs from the stable sort")
    del srt, oracle
    torch.cuda.empty_cache()
    launched = {k: c for k, c in K.launches().items() if c}

    # the count-and-discard selects where rank k sits on a dtype extreme
    extremes = {}
    for dtype in (torch.float32, torch.int32):
        e = _extreme_data(dtype, 0)
        flat_sorted = torch.sort(e.reshape(-1)).values
        for q in (0.0, 0.01, 0.99, 1.0):
            want = flat_sorted[local_ops.target_rank(e.numel(), q) - 1]
            for name, fn, seed in selects[1:]:
                _check_bits(f"{name} {dtype} q={q}", fn(e, q), want)
                r = bl.count_discard_rounds(e, q, seed=seed)
                if r > 4 * math.log2(e.numel()):
                    raise AssertionError(f"{name} {dtype} q={q}: {r} rounds")
                extremes[f"{name}_{str(dtype)[6:]}_q{q}"] = {
                    "answer": float(want), "rounds": r}
        del e, flat_sorted
    torch.cuda.empty_cache()
    full = out["median_s"]["full_sort_quantile_q0.5"]
    out.update({
        "gk_select_median_s": gk_median_s,
        "full_sort_over_gk_select": full / gk_median_s,
        "ratio_note": "one H100 against one H100 (both on the card), not "
                      "the paper's 30-core cluster",
        "launches": launched, "extremes": extremes,
        "wall_s": time.perf_counter() - t_phase})
    return out


# ---------------------------------------------------------------------------
# 6. the grouped path
# ---------------------------------------------------------------------------


def _tenant_data(seed: int):
    """(P, N_I) float32 latencies and int32 tenant keys: traffic shares
    from Dirichlet(0.5), lognormal(1.0, 0.6) x (1 + 0.3 tenant)."""
    import numpy as np
    shares = np.random.default_rng(seed).dirichlet(np.full(GROUPS, 0.5))
    edges = torch.tensor(np.cumsum(shares)[:-1], dtype=torch.float32,
                         device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    values = torch.empty((P, N_I), dtype=torch.float32, device="cuda")
    keys = torch.empty((P, N_I), dtype=torch.int32, device="cuda")
    for i in range(0, P, 8):
        u = torch.rand((min(8, P - i), N_I), generator=gen, device="cuda")
        keys[i:i + 8] = torch.searchsorted(edges, u, right=True, out_int32=True)
        z = torch.randn((min(8, P - i), N_I), generator=gen, device="cuda")
        values[i:i + 8] = torch.exp(z * 0.6 + 1.0) * (1.0 + 0.3 * keys[i:i + 8])
    return values, keys


def _grouped_oracle(values, keys, num_groups=GROUPS, qs=GROUP_QS,
                    rank=None):
    """Every (group, level) cell from one sort of (key, value) pairs on the
    card: the ``rank(n_g, q)``-th value of group g (``exact_target_rank``
    unless given)."""
    from repro_torch.core import local_ops
    from repro_torch.kernels import ref
    rank = rank or local_ops.exact_target_rank
    comp = (keys.reshape(-1).to(torch.int64) << 32) | ref.u32_as_int64(
        ref.to_sortable_u32(values.reshape(-1)))
    srt = torch.sort(comp).values
    del comp
    n_g = torch.bincount(keys.reshape(-1), minlength=num_groups).tolist()
    start, idx = 0, []
    for g in range(num_groups):
        idx += [start + rank(n_g[g], q) - 1 for q in qs]
        start += n_g[g]
    low = srt[torch.tensor(idx, device="cuda")].to(torch.int32)
    del srt
    torch.cuda.empty_cache()
    return ref.from_sortable_u32(low.view(torch.uint32), torch.float32).reshape(
        num_groups, len(qs)), n_g


def grouped_path(seed: int):
    import repro_torch.kernels as K
    from repro_torch.core import engine, gk_select_grouped, local_ops
    from repro_torch.core import grouped as gr
    from repro_torch.kernels import ops, ref, segmented_select as ss

    values, keys = _tenant_data(seed)
    want, n_g = _grouped_oracle(values, keys)
    n = values.numel()
    G, Q = GROUPS, len(GROUP_QS)

    def query():
        return gk_select_grouped(values, keys, GROUP_QS, num_groups=G,
                                 eps=EPS, block_select=True)

    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    got = query()
    torch.cuda.synchronize()
    launched = K.launches()
    if launched["segmented_select"] < 1:
        raise AssertionError("segmented_select was not launched on the "
                             "grouped path")
    if not torch.equal(_bits(got), _bits(want)):
        bad = int((_bits(got) != _bits(want)).sum())
        raise AssertionError(f"gk_select_grouped: {bad} of {G * Q} cells "
                             f"differ from the oracle")
    got, median_s = _median_s(query)
    runs_peak = torch.cuda.max_memory_allocated()
    if not torch.equal(_bits(got), _bits(want)):
        raise AssertionError("gk_select_grouped changed between runs")
    ops.reset_hbm_passes()
    query()
    passes = ops.hbm_passes()

    # phases of one query, the same calls
    phases = {}
    _, phases["nan_check"] = _sync_time(lambda: local_ops.reject_nans(values,
                                                                      "x"))
    s = gr.grouped_sketch_samples(EPS, N_I)
    (vals, wts, counts, mslack), phases["segmented_sketch_sort"] = _sync_time(
        lambda: gr._sketch(values, keys, G, s))

    def pivot_query():
        g_vals = vals.transpose(0, 1).reshape(G, -1)
        g_wts = wts.transpose(0, 1).reshape(G, -1)
        kmat = gr.grouped_target_ranks(counts.sum(0, dtype=torch.int32),
                                       GROUP_QS)
        return kmat, gr.query_grouped_sketch(
            g_vals, g_wts, mslack.sum(0, dtype=torch.int32), kmat)

    (kmat, pivots), phases["grouped_pivot_query"] = _sync_time(pivot_query)
    del vals, wts
    cap = local_ops.candidate_cap(n, EPS, N_I)
    (c, b, a), phases["segmented_count_extract"] = _sync_time(
        lambda: ops.segmented_count_extract(values, keys, pivots, cap))

    def resolve():
        below = b.permute(1, 2, 0, 3).reshape(G * Q, P * cap)
        above = a.permute(1, 2, 0, 3).reshape(G * Q, P * cap)
        return engine.phase_resolve(
            pivots.reshape(G * Q), kmat.reshape(G * Q),
            c.sum(0, dtype=torch.int32).reshape(G * Q, 3), below, above, cap)

    _, phases["resolve"] = _sync_time(resolve)
    del c, b, a
    torch.cuda.empty_cache()

    profiles = {"gk_select_grouped": _profile(query),
                "segmented_select": _profile(
                    lambda: ss.segmented_select(values, keys, pivots, cap))}
    kernels = [_kernel_row(
        "segmented_select", launched["segmented_select"],
        lambda: ss.segmented_select(values, keys, pivots, cap),
        lambda: ref.segmented_select_ref(values, keys, pivots, cap), None,
        "none: no single PyTorch call computes it; the nearest calls are "
        "the plain version's per-(g, q) masked torch.topk and counts",
        n * 8 + P * G * Q * (3 * 4 + 2 * cap * 4), plain_iters=1)]
    return {
        "n": n, "shards": P, "groups": G, "qs": list(GROUP_QS), "eps": EPS,
        "cap": cap, "sketch_s": s, "group_counts": n_g,
        "answers": got.tolist(), "gk_select_grouped_median_s": median_s,
        "phases_s": phases, "passes": passes, "launches": launched,
        "peak_memory_bytes": runs_peak,
        "histogram_reads": ss.reads_per_launch(torch.float32, G, Q) - 1,
        "profiles": profiles}, kernels, (values, keys, want)


# ---------------------------------------------------------------------------
# 7. the streaming service
# ---------------------------------------------------------------------------


def _kernel_events(fn) -> dict:
    """CUDA kernels and copies one call of fn launches, by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {"kernels": 0, "memcpy": 0, "memset": 0, "by_name": {}}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA \
                or "Buffer" in evt.name:
            continue
        kind = ("memcpy" if "Memcpy" in evt.name else
                "memset" if "Memset" in evt.name else "kernels")
        out[kind] += 1
        name = evt.name.replace("void ", "").split("<")[0].split("(")[0]
        out["by_name"][name] = out["by_name"].get(name, 0) + 1
    return out


def _counted(fn, expect_sorts=None, expect=None) -> tuple:
    """One call of fn with every count zeroed just before it: ``(result,
    {"launches", "sketch_sorts", "hbm_passes"})``; raises if a kernel of
    ``expect`` did not launch its expected number of times, or the sketch
    sorts differ from ``expect_sorts``."""
    import repro_torch.kernels as K
    from repro_torch.core import sketch as sk
    from repro_torch.kernels import ops
    K.reset_launches()
    sk.reset_sketch_sorts()
    ops.reset_hbm_passes()
    out = fn()
    torch.cuda.synchronize()
    counts = {"launches": {k: c for k, c in K.launches().items() if c},
              "sketch_sorts": sk.sketch_sorts(),
              "hbm_passes": ops.hbm_passes()}
    for name, n in (expect or {}).items():
        if counts["launches"].get(name, 0) != n:
            raise AssertionError(f"{name} launched {counts['launches']}, "
                                 f"expected {n}")
    if expect_sorts is not None and counts["sketch_sorts"] != expect_sorts:
        raise AssertionError(f"{counts['sketch_sorts']} sketch sorts, "
                             f"expected {expect_sorts}")
    return out, counts


def _check_bits(what: str, got, want) -> None:
    if not torch.equal(_bits(got.reshape(-1)), _bits(want.reshape(-1))):
        raise AssertionError(f"{what}: {got} != oracle {want}")


def _warm_phases(svc, name: str, q: float) -> dict:
    """The phases of one warm ``exact``, the service's own calls in turn."""
    from repro_torch.core import local_ops, sketch as sk
    from repro_torch.kernels import ops
    from repro_torch.launch import quantile_service as qsvc
    slot = svc._names[name]
    n = svc._counts[slot]
    k = local_ops.target_rank(n, q)
    state = svc._row_state(slot)
    chunks = svc._chunks_for(slot)
    phases = {}
    (pivot, bound), phases["pivot"] = _sync_time(
        lambda: (sk.sketch_query_rank(state, k),
                 int(sk.sketch_rank_bound(state))))
    cap = min(n, qsvc._round_up(bound + 2, 128))
    outs, phases["count_extract"] = _sync_time(
        lambda: [ops.fused_count_extract(c, pivot, min(c.shape[0], cap))
                 for c in chunks])

    def resolve():
        total = torch.stack([o[0] for o in outs]).sum(0, dtype=torch.int32)
        return local_ops.resolve(
            pivot, torch.tensor(k, dtype=torch.int32, device="cuda"),
            total[0], total[1], torch.cat([o[1] for o in outs]),
            torch.cat([o[2] for o in outs]), cap)

    _, phases["resolve"] = _sync_time(resolve)
    _, phases["cold_sketch"] = _sync_time(lambda: svc._cold_pivot(chunks, k))
    return {"phases_s": phases, "cap": cap, "rank_bound": bound,
            "chunks": len(chunks)}


def _all_phases(svc, qs) -> dict:
    """The phases of one fused ``exact_all``: pivots from the table, the
    count+extract over the ring, the resolve."""
    from repro_torch.core import local_ops, sketch as sk
    from repro_torch.launch import quantile_service as qsvc
    active = [(n, s) for n, s in sorted(svc._names.items())
              if svc._counts[s] > 0]
    G, Q = len(active), len(qs)
    slots = [s for _, s in active]
    gid_of_slot = {s: g for g, s in enumerate(slots)}
    counts = [svc._counts[s] for s in slots]
    phases = {}

    def pivots():
        rows = qsvc._gather_rows(svc._stacked, svc._slot_index(slots))
        kmat = torch.tensor([[local_ops.target_rank(c, q) for q in qs]
                             for c in counts], dtype=torch.int32,
                            device="cuda")
        return (kmat, sk.sketch_query_rank_batch(rows, kmat),
                int(sk.sketch_rank_bound(rows).max()))

    (kmat, piv, bound), phases["pivot"] = _sync_time(pivots)
    cap = min(max(counts), qsvc._round_up(bound + 2, 128))
    _, phases["count_extract_resolve"] = _sync_time(
        lambda: svc._segmented_resolve(lambda: svc._ring_pairs(gid_of_slot),
                                       kmat, piv, cap, G, Q, max(counts)))
    return {"phases_s": phases, "cap": cap, "rank_bound": bound,
            "records": len(svc._ring)}


def service_path(x, want, want_multi, gk_median_s: float, tally) -> tuple:
    """One stream at the paper's size: the main path's array ingested as
    120 ticks of one 2^23-value row, eps = 1e-4 (budget 65,536), fused.
    Warm and cold ``exact(0.5)``, ``exact_all`` over the 5 levels and
    ``approx``, each against the sort oracles bit for bit, then a snapshot
    round trip whose warm ``exact`` replays no history."""
    import tempfile
    from repro_torch.checkpoint import (restore_service_snapshot,
                                        save_service_snapshot)
    from repro_torch.core import sketch as sk
    from repro_torch.kernels import (fused_select as fs, ref,
                                     segmented_select as ss)
    from repro_torch.launch import QuantileService, roofline
    from repro_torch.launch import quantile_service as qsvc

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    svc = QuantileService(eps=EPS, fused=True)
    qsvc.reset_ingest_dispatches()
    sk.reset_sketch_sorts()

    def ingest():
        for i in range(P):
            svc.ingest("main", x[i])

    _, ingest_counts = _counted(ingest, expect_sorts=P)
    ingest_s = time.perf_counter() - t_phase
    ingest_counts["ingest_dispatches"] = qsvc.ingest_dispatches()
    scratch = QuantileService(eps=EPS, fused=True)
    scratch.ingest("main", x[0])
    tick_events = _kernel_events(lambda: scratch.ingest("main", x[1]))
    del scratch

    queries = {
        "exact_warm": (lambda: svc.exact("main", 0.5), want, 0,
                       {"fused_select": P}),
        "exact_cold": (lambda: svc.exact("main", 0.5, warm=False), want, P,
                       {"fused_select": P}),
        "exact_all": (lambda: svc.exact_all(QS)["main"], want_multi, 0,
                      {"segmented_select": P}),
        "approx": (lambda: svc.approx("main", 0.5), None, 0, {}),
    }
    per_query, medians = {}, {}
    for name, (fn, oracle, sorts, expect) in queries.items():
        got, per_query[name] = _counted(fn, sorts, expect)
        if oracle is not None:
            _check_bits(f"service {name}", got, oracle)
        again, medians[name + "_median_s"] = _median_s(fn)
        if not torch.equal(_bits(again), _bits(got)):
            raise AssertionError(f"service {name} changed between runs")
    warm = _warm_phases(svc, "main", 0.5)
    all_ = _all_phases(svc, QS)
    profiles = {"exact_warm": _profile(queries["exact_warm"][0]),
                "exact_all": _profile(queries["exact_all"][0])}
    peak = torch.cuda.max_memory_allocated()

    # the kernels at the service's shapes against their plain versions
    slot = svc._names["main"]
    rec = svc._ring[0]
    chunk = rec.data[0:1, :int(rec.n_valid[0])]
    pivot = sk.sketch_query_rank(svc._row_state(slot), N_I)
    cap = min(chunk.shape[1], warm["cap"])
    tally.add("fused_select", _same_bits(fs.fused_select(chunk, pivot, cap),
                                         ref.fused_select_ref(chunk, pivot,
                                                              cap)),
              f"service chunk 1 x {chunk.shape[1]} cap={cap}")
    chunk_ms = _event_ms(lambda: fs.fused_select(chunk, pivot, cap), 5)
    chunk_bound_ms = (chunk.numel() * 4 + 3 * 4 + 2 * cap * 4) \
        / roofline.HBM_BW * 1e3
    keys = torch.zeros_like(chunk, dtype=torch.int32)
    piv = sk.sketch_query_rank_batch(
        qsvc._gather_rows(svc._stacked, svc._slot_index([slot])),
        torch.tensor([[max(1, int(q * P * N_I)) for q in QS]],
                     dtype=torch.int32, device="cuda"))
    cap = min(chunk.shape[1], all_["cap"])
    tally.add("segmented_select",
              _same_bits(ss.segmented_select(chunk, keys, piv, cap),
                         ref.segmented_select_ref(chunk, keys, piv, cap)),
              f"service record 1 x {chunk.shape[1]} G*Q=5 cap={cap}")

    # snapshot, restore, warm exact with no replay
    with tempfile.TemporaryDirectory() as tmp:
        _, save_s = _sync_time(lambda: save_service_snapshot(tmp, 1, svc))
        restored, restore_s = _sync_time(lambda: restore_service_snapshot(tmp))
        got, restored_counts = _counted(lambda: restored.exact("main", 0.5),
                                        0, {"fused_select": P})
        _check_bits("restored exact", got, want)
    del restored, svc
    torch.cuda.empty_cache()
    return {
        "n": P * N_I, "ticks": P, "eps": EPS, "budget": sk.sketch_budget(EPS),
        "ingest_s": ingest_s, "ingest_counts": ingest_counts,
        "ingest_tick_device_events": tick_events, **medians,
        "gk_select_median_s": gk_median_s,
        "per_query": per_query, "warm_exact": warm, "exact_all": all_,
        "fused_select_one_chunk_ms": chunk_ms,
        "fused_select_one_chunk_bound_ms": chunk_bound_ms,
        "snapshot_save_s": save_s, "snapshot_restore_s": restore_s,
        "restored_exact": restored_counts,
        "peak_memory_bytes": peak, "allocated_before_bytes": base,
        "profiles": profiles,
        "wall_s": time.perf_counter() - t_phase}, per_query


def _tenant_ticks(seed: int):
    """TENANTS streams x TENANT_TICKS ticks of telemetry: each (tick,
    stream) batch length from 1..TENANT_LEN by ``seed``, values
    lognormal(1.0, 0.6) x (1 + 0.3 (stream mod 32)) in f32, made on the card
    and handed to the service as host arrays.  Returns the host batches per
    tick and all values with their stream ids on the card."""
    import numpy as np
    lengths = np.random.default_rng(seed).integers(
        1, TENANT_LEN + 1, size=(TENANT_TICKS, TENANTS))
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    ticks, vals, sids = [], [], []
    for t in range(TENANT_TICKS):
        lens = torch.as_tensor(lengths[t], device="cuda")
        sid = torch.repeat_interleave(
            torch.arange(TENANTS, device="cuda", dtype=torch.int32), lens)
        z = torch.randn(sid.numel(), generator=gen, device="cuda")
        v = torch.exp(z * 0.6 + 1.0) * (1.0 + 0.3 * (sid % 32))
        ticks.append(np.split(v.cpu().numpy(), np.cumsum(lengths[t])[:-1]))
        vals.append(v)
        sids.append(sid)
    return ticks, torch.cat(vals), torch.cat(sids), lengths


def tenants_path(seed: int, tally) -> tuple:
    """Multi-tenant telemetry: TENANTS streams over TENANT_TICKS host ticks,
    eps = 0.01 (budget 1600).  ``exact_all`` fused (segmented_select) and
    row-wise, warm ``exact`` on 8 streams, 4 worker buffers folded in one
    ``fold_many``, and a windowed service (8 ticks, 4 sub-windows): every
    exact answer against a sort of the raw values, bit for bit;
    ``approx_decayed`` against the CPU port on the same state."""
    import numpy as np
    from repro_torch.core import local_ops, sketch as sk
    from repro_torch.kernels import (fused_select as fs, ref,
                                     segmented_select as ss)
    from repro_torch.launch import QuantileService, Window, roofline
    from repro_torch.launch import quantile_service as qsvc

    t_phase = time.perf_counter()
    ticks, values, sids, lengths = _tenant_ticks(seed)
    want, _ = _grouped_oracle(values, sids, TENANTS, TENANT_QS,
                              local_ops.target_rank)
    del values, sids
    torch.cuda.empty_cache()
    setup_s = time.perf_counter() - t_phase
    names = [f"tenant{i:04d}" for i in range(TENANTS)]
    probe = sorted({s for s in (0, 1, 7, 31, 100, 1000, TENANTS // 2 - 1,
                                TENANTS - 1) if s < TENANTS})  # 8 streams

    # launches per ingest tick at S = 1 and S = TENANTS, the same lengths
    scratch = QuantileService(eps=TENANT_EPS, fused=True)
    scratch.ingest_batch(names, ticks[0])
    one = [np.resize(ticks[0][0], TENANT_LEN)]
    one_dev = [torch.from_numpy(one[0]).cuda()]
    many_dev = [torch.from_numpy(b).cuda() for b in ticks[2]]
    tick_events = {
        "host_S1": _kernel_events(lambda: scratch.ingest_batch(names[:1],
                                                               one)),
        f"host_S{TENANTS}": _kernel_events(
            lambda: scratch.ingest_batch(names, ticks[1])),
        "device_S1": _kernel_events(lambda: scratch.ingest_batch(
            names[:1], one_dev)),
        f"device_S{TENANTS}": _kernel_events(lambda: scratch.ingest_batch(
            names, many_dev))}
    del scratch, one_dev, many_dev

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    svc = QuantileService(eps=TENANT_EPS, fused=True)
    qsvc.reset_ingest_dispatches()

    def ingest():
        for t in range(TENANT_TICKS):
            svc.ingest_batch(names, ticks[t])

    (_, ingest_counts), ingest_s = _sync_time(
        lambda: _counted(ingest, expect_sorts=TENANT_TICKS))
    ingest_counts["ingest_dispatches"] = qsvc.ingest_dispatches()
    per_launch = max(1, ss.MAX_PIVOTS // len(TENANT_QS))
    seg_launches = TENANT_TICKS * -(-TENANTS // per_launch)

    def answers(out):
        return torch.stack([out[n] for n in names])

    def all_fused():
        svc.fused = True
        return answers(svc.exact_all(TENANT_QS))

    def all_rowwise():
        svc.fused = False
        try:
            return answers(svc.exact_all(TENANT_QS))
        finally:
            svc.fused = True

    def warm():
        return torch.stack([svc.exact(names[s], q) for s in probe
                            for q in TENANT_QS])

    want_probe = want[probe].reshape(-1)
    queries = {"exact_all_fused": (all_fused, want,
                                   {"segmented_select": seg_launches}),
               "exact_all_rowwise": (all_rowwise, want, {}),
               "exact_warm_8_streams": (
                   warm, want_probe,
                   {"fused_select": TENANT_TICKS * len(probe) *
                    len(TENANT_QS)})}
    per_query, medians = {}, {}
    for name, (fn, oracle, expect) in queries.items():
        got, per_query[name] = _counted(fn, 0, expect)
        if name == "exact_all_rowwise" and per_query[name]["launches"]:
            raise AssertionError(f"the row-wise route launched "
                                 f"{per_query[name]['launches']}")
        _check_bits(f"tenants {name}", got, oracle)
        _, medians[name + "_median_s"] = _median_s(fn)
    all_ = _all_phases(svc, TENANT_QS)
    profiles = {"exact_all_fused": _profile(all_fused)}
    peak = torch.cuda.max_memory_allocated()
    stats = svc.memory_stats()

    # the kernels at the service's shapes against their plain versions:
    # every chunk of 4 streams, and a tick record's first 256 rows at one
    # launch's G*Q pivots
    for s in probe[:4]:
        slot = svc._names[names[s]]
        pivot = sk.sketch_query_rank(svc._row_state(slot), 1 + int(
            0.5 * svc._counts[slot]))
        cap = min(svc._counts[slot], qsvc._round_up(
            int(sk.sketch_rank_bound(svc._row_state(slot))) + 2, 128))
        for c in svc._chunks_for(slot):
            c = c.reshape(1, -1)
            cc = min(c.shape[1], cap)
            tally.add("fused_select",
                      _same_bits(fs.fused_select(c, pivot, cc),
                                 ref.fused_select_ref(c, pivot, cc)),
                      f"tenant chunk 1 x {c.shape[1]} cap={cc}")
    rows = 256
    rec = svc._ring[0]
    gid_of_slot = {svc._names[n]: g for g, n in enumerate(sorted(names))}
    v, k = next(svc._ring_pairs(gid_of_slot))
    v_rec, k_rec = v.reshape(1, -1), k.reshape(1, -1)
    v = v.reshape(rec.data.shape)[:rows].reshape(1, -1)
    k = k.reshape(rec.data.shape)[:rows].reshape(1, -1)
    table = qsvc._gather_rows(svc._stacked, svc._slot_index(
        [svc._names[n] for n in sorted(names)]))
    kmat = torch.tensor([[local_ops.target_rank(svc._counts[svc._names[n]], q)
                          for q in TENANT_QS] for n in sorted(names)],
                        dtype=torch.int32, device="cuda")
    grid = sk.sketch_query_rank_batch(table, kmat)
    cap = min(v.shape[1], all_["cap"])
    # one launch of a whole record at one launch's pivots, alone
    record_ms = _event_ms(lambda: ss.segmented_select(
        v_rec, k_rec, grid[:per_launch], cap), 3)
    record_bound_ms = (v_rec.numel() * 8 + grid[:per_launch].numel() * (
        3 * 4 + 2 * cap * 4)) / roofline.HBM_BW * 1e3
    del v_rec, k_rec
    for g0 in range(0, TENANTS, per_launch):
        kk = k - g0
        pv = grid[g0:g0 + per_launch]
        tally.add("segmented_select",
                  _same_bits(ss.segmented_select(v, kk, pv, cap),
                             ref.segmented_select_ref(v, kk, pv, cap)),
                  f"tenant record {rows} x {rec.data.shape[1]} G*Q="
                  f"{pv.numel()} cap={cap}")
    serial = all_fused()
    del svc, table, grid, v, k
    torch.cuda.empty_cache()

    # the same ticks staged into 4 worker buffers, folded in one call
    folded = QuantileService(eps=TENANT_EPS, fused=True)
    bufs = [folded.local_buffer() for _ in range(4)]
    (_, fold_s) = _sync_time(lambda: [
        bufs[t % 4].stage(names[i], ticks[t][i])
        for t in range(TENANT_TICKS) for i in range(TENANTS)])
    _, fold_many_s = _sync_time(lambda: folded.fold_many(bufs))
    got = answers(folded.exact_all(TENANT_QS))
    _check_bits("fold_many exact_all", got, serial)
    del folded, bufs

    # a windowed service over the same ticks
    win = QuantileService(eps=TENANT_EPS, fused=True, window_ticks=8,
                          window_subs=4)
    for t in range(TENANT_TICKS):
        win.ingest_batch(names, ticks[t])
    wstats = win.memory_stats()
    if wstats["ring_records"] > 8:
        raise AssertionError(f"windowed ring holds {wstats['ring_records']}")
    checked = 0
    for s in probe:
        hist = [ticks[t][s] for t in range(TENANT_TICKS)]
        # a values window inside what the ring retains
        n_w = min(2 * TENANT_LEN, sum(h.size for h in hist[-8:]) - 1)
        for w, raw in ((Window(ticks=8), np.concatenate(hist[-8:])),
                       (Window(values=n_w), np.concatenate(hist)[-n_w:])):
            srt = np.sort(raw)
            for q in TENANT_QS:
                got = win.windowed(names[s], q, window=w)
                ref_v = torch.from_numpy(
                    srt[local_ops.target_rank(srt.size, q) - 1:][:1]).cuda()
                _check_bits(f"windowed {names[s]} {w} {q}", got, ref_v)
                checked += 1
    leaves, extra = win.snapshot()
    cpu = QuantileService.from_snapshot(leaves, extra, device="cpu")
    decayed_equal = 0
    for s in probe:
        for q in TENANT_QS:
            a = win.approx_decayed(names[s], q, halflife=4.0)
            b = cpu.approx_decayed(names[s], q, halflife=4.0)
            if not torch.equal(_bits(a.cpu()), _bits(b)):
                raise AssertionError(f"approx_decayed {names[s]} {q}: card "
                                     f"{a} != CPU {b}")
            decayed_equal += 1
    _, win_median = _median_s(lambda: win.windowed(names[0], 0.99,
                                                   window=Window(ticks=8)))
    del win, cpu, leaves
    torch.cuda.empty_cache()
    return {
        "streams": TENANTS, "ticks": TENANT_TICKS, "eps": TENANT_EPS,
        "budget": sk.sketch_budget(TENANT_EPS),
        "values": int(lengths.sum()), "setup_s": setup_s,
        "ingest_s": ingest_s, "ingest_counts": ingest_counts,
        "ingest_tick_device_events": tick_events,
        "segmented_launches_per_record": -(-TENANTS // per_launch),
        "segmented_select_one_record_ms": record_ms,
        "segmented_select_one_record_bound_ms": record_bound_ms,
        **medians, "per_query": per_query, "exact_all": all_,
        "stage_4_buffers_s": fold_s, "fold_many_s": fold_many_s,
        "windowed_checked": checked, "windowed_median_s": win_median,
        "decayed_equal_to_cpu": decayed_equal, "window_memory": wstats,
        "memory": stats, "peak_memory_bytes": peak, "profiles": profiles,
        "wall_s": time.perf_counter() - t_phase}, per_query


# ---------------------------------------------------------------------------
# 8. the sharded path: a world of W ranks, each a process, on the one card
# ---------------------------------------------------------------------------


def _rank_setup(rank: int, world: int, store: str, backend: str):
    """A rank's start: the port on its path, the card, the process group."""
    sys.path.insert(0, os.path.join(HERE, "src"))
    torch.cuda.set_device(0)
    import torch.distributed as dist
    dist.init_process_group(backend, init_method=f"file://{store}",
                            world_size=world, rank=rank)
    return dist


def _timed_runs(dist, fn) -> tuple:
    """(last result, seconds of TIMED_RUNS runs after one warm-up), every
    run started at a barrier of the world and ended by a synchronize."""
    out, times = None, []
    for _ in range(TIMED_RUNS + 1):
        dist.barrier()
        out, t = _sync_time(fn)
        times.append(t)
    return out, times[1:]


def _sharded_parity(dist, coll, x, v, k, pivots, gpiv, cap) -> list:
    """The four kernels of the sharded path on this rank's shard, at the
    path's shapes (one shard of 167.8M values, its pivots and cap), against
    their plain versions on the same card inputs, bit for bit.  The ranks
    take turns, so that one plain version runs on the card at a time.
    Returns [kernel, passed, case] for the parity tally."""
    from repro_torch.core import local_ops
    from repro_torch.kernels import ops, ref
    p = pivots[QS.index(0.5)]
    cases = (("fused_select", lambda: ops.fused_count_extract(x, p, cap),
              lambda: ref.fused_select_ref(x, p, cap)),
             ("fused_select_multi",
              lambda: ops.fused_count_extract_multi(x, pivots, cap),
              lambda: ref.fused_select_multi_ref(x, pivots, cap)),
             ("partition_count", lambda: (ops.count3(x, p),),
              lambda: (local_ops.count3(x, p),)),
             ("segmented_select",
              lambda: ops.segmented_count_extract(v, k, gpiv, cap),
              lambda: ref.segmented_select_ref(v, k, gpiv, cap)))
    out = []
    for turn in range(coll.size):
        dist.barrier()
        if turn != coll.rank:
            continue
        for name, kernel, plain in cases:
            got, want = kernel(), plain()
            out.append([name, _same_bits(got, want),
                        f"sharded rank {coll.rank} shard {x.numel()} "
                        f"cap={cap}"])
            del got, want
            torch.cuda.empty_cache()
    dist.barrier()
    return out


def _sharded_phases(dist, x, v, k):
    """Phase times of one fused multi-level query and one grouped query,
    each phase between a barrier and a synchronize (this rank's clock);
    then ``_sharded_parity`` at their pivots and cap."""
    from repro_torch.core import engine, grouped as gr, local_ops
    from repro_torch.kernels import ops
    coll = engine.Collectives()
    n = x.numel() * coll.size

    def timed(fn):
        dist.barrier()
        return _sync_time(fn)

    multi, grouped = {}, {}
    (g_vals, g_wts, m), multi["sketch_all_gather"] = timed(
        lambda: engine.phase_sketch(x, coll=coll, n=n, eps=EPS))
    ks = torch.tensor([local_ops.target_rank(n, q) for q in QS],
                      dtype=torch.int32, device=x.device)
    pivots, multi["pivot"] = timed(lambda: engine.phase_pivot(
        g_vals, g_wts, ks, num_shards=coll.size, m=m))
    cap = local_ops.candidate_cap(n, EPS, x.numel())
    (c, b, a), multi["count_extract"] = timed(
        lambda: engine.phase_count_extract(
            x, pivots, cap, coll=coll, fused_fn=ops.make_fused_multi_fn()))
    (b, a), multi["reduce"] = timed(
        lambda: engine.phase_reduce(b, a, coll=coll))
    _, multi["resolve"] = timed(
        lambda: engine.phase_resolve(pivots, ks, c, b, a, cap))
    del g_vals, g_wts, b, a

    G, Q = GROUPS, len(GROUP_QS)
    s = gr.grouped_sketch_samples(EPS, v.numel())
    (g_vals, g_wts, n_g, slack), grouped["sketch_all_gather"] = timed(
        lambda: gr.phase_grouped_sketch(v, k, coll=coll, num_groups=G, s=s))

    def pivot():
        kmat = gr.grouped_target_ranks(n_g, GROUP_QS)
        return kmat, gr.query_grouped_sketch(g_vals, g_wts, slack, kmat)

    (kmat, gpiv), grouped["pivot"] = timed(pivot)
    del g_vals, g_wts
    (c, b, a), grouped["count_extract"] = timed(
        lambda: gr.phase_grouped_count_extract(
            v, k, gpiv, cap, coll=coll, segmented_fn=ops.make_segmented_fn()))
    (b, a), grouped["reduce"] = timed(lambda: engine.phase_reduce(
        b.reshape(G * Q, -1), a.reshape(G * Q, -1), coll=coll))
    _, grouped["resolve"] = timed(lambda: engine.phase_resolve(
        gpiv.reshape(G * Q), kmat.reshape(G * Q), c.reshape(G * Q, 3), b, a,
        cap))
    del b, a
    parity = _sharded_parity(dist, coll, x, v, k, pivots, gpiv, cap)

    # rank 0's band kernels alone (the other ranks wait at a barrier), on
    # its one shard and on the same values as 20 shards of 2^23
    alone = {}
    if coll.rank == 0:
        fused, seg = ops.make_fused_multi_fn(), ops.make_segmented_fn()
        alone = {
            "fused_select_multi_1_shard": _profile(
                lambda: fused(x, pivots, cap)),
            "fused_select_multi_20_shards": _profile(
                lambda: fused(x.reshape(-1, N_I), pivots, cap)),
            "segmented_select_1_shard": _profile(
                lambda: seg(v, k, gpiv, cap))}
    dist.barrier()
    return {"distributed_quantile_multi": multi,
            "distributed_quantile_grouped": grouped}, parity, alone


# the sharded queries: name -> (kernel each must launch, oracle's name)
SHARDED_QUERIES = {"fused_q50": ("fused_select", "single"),
                   "faithful_q50": ("partition_count", "single"),
                   "multi_cold": ("fused_select_multi", "multi"),
                   "multi_warm": ("fused_select_multi", "multi"),
                   "grouped": ("segmented_select", "grouped")}


def _sharded_rank(rank: int, world: int, store: str, out_dir: str,
                  shared: list) -> None:
    """One rank of the sharded phase: its 1/world of the main path's and
    the grouped path's data (``shared``: the parent's tensors, by CUDA IPC;
    emptied here, so that this rank's references end with it), every query
    of ``SHARDED_QUERIES`` timed, its launches and collectives counted, its
    answers written to ``out_dir/rank<r>.json``."""
    x, values, keys = shared
    shared.clear()
    dist = _rank_setup(rank, world, store, "gloo")
    import repro_torch.kernels as K
    from repro_torch.core import (distributed_quantile,
                                  distributed_quantile_grouped,
                                  distributed_quantile_multi, engine,
                                  local_ops)
    torch.cuda.reset_peak_memory_stats()
    xl = x.reshape(world, -1)[rank]
    vl = values.reshape(world, -1)[rank]
    kl = keys.reshape(world, -1)[rank]
    coll = engine.Collectives()
    # the warm job's pivots: what a maintained sketch would hand it
    g_vals, g_wts, m = engine.phase_sketch(xl, coll=coll, n=x.numel(),
                                           eps=EPS)
    warm = engine.phase_pivot(g_vals, g_wts, torch.tensor(
        [local_ops.target_rank(x.numel(), q) for q in QS], device=x.device),
        num_shards=world, m=m)
    del g_vals, g_wts
    calls = {
        "fused_q50": lambda: distributed_quantile(xl, 0.5, eps=EPS,
                                                  fused=True),
        "faithful_q50": lambda: distributed_quantile(xl, 0.5, eps=EPS),
        "multi_cold": lambda: distributed_quantile_multi(xl, QS, eps=EPS,
                                                         fused=True),
        "multi_warm": lambda: distributed_quantile_multi(
            xl, QS, eps=EPS, fused=True, pivots=warm),
        "grouped": lambda: distributed_quantile_grouped(
            vl, kl, GROUP_QS, num_groups=GROUPS, eps=EPS, fused=True,
            check_nans=False)}
    record = {"rank": rank, "queries": {}}
    for name, call in calls.items():
        K.reset_launches()
        engine.reset_collectives()
        got, runs = _timed_runs(dist, call)
        launched = K.launches()
        record["queries"][name] = {
            "answer_bits": _bits(got).reshape(-1).tolist(),
            "median_s": statistics.median(runs), "runs_s": runs,
            "launches_per_query": {kn: c / (TIMED_RUNS + 1)
                                   for kn, c in launched.items() if c},
            "collectives_per_query": {kn: c / (TIMED_RUNS + 1) for kn, c in
                                      engine.collectives().items()}}
    (record["phases_s"], record["parity"],
     record["kernels_alone"]) = _sharded_phases(dist, xl, vl, kl)
    # rank 0's device time by kernel in one query of each kind, every rank
    # running it
    record["profiles"] = {}
    for name in ("multi_cold", "grouped"):
        dist.barrier()
        if rank == 0:
            record["profiles"][name] = _profile(calls[name])
        else:
            calls[name]()
            calls[name]()
    record["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
        json.dump(record, fh)
    del x, values, keys, xl, vl, kl, calls      # release the parent's memory
    torch.cuda.synchronize()
    dist.destroy_process_group()


def _nccl_rank(rank: int, world: int, store: str, out_dir: str,
               shared: list) -> None:
    """A world of one rank on NCCL: ``distributed_quantile_multi`` and the
    PSRS plan (``method="full_sort"``, its all_to_all) on a CUDA shard
    (``shared``, as ``_sharded_rank``), the collectives passing the card's
    tensors as they are."""
    x, = shared
    shared.clear()
    dist = _rank_setup(rank, world, store, "nccl")
    from repro_torch.core import (distributed_quantile,
                                  distributed_quantile_multi, engine,
                                  local_ops)
    engine.reset_collectives()
    got = distributed_quantile_multi(x, QS, eps=EPS, fused=True)
    got_sort = distributed_quantile(x, 0.5, method="full_sort")
    counts = engine.collectives()
    ks = torch.tensor([local_ops.target_rank(x.numel(), q) for q in QS],
                      device=x.device)
    want = torch.sort(x).values[ks - 1]
    with open(os.path.join(out_dir, "nccl.json"), "w") as fh:
        json.dump({"exact": bool(torch.equal(_bits(got), _bits(want))),
                   "exact_full_sort": bool(torch.equal(
                       _bits(got_sort), _bits(want[QS.index(0.5)]))),
                   "answers": got.tolist(), "collectives": counts}, fh)
    del x                                       # release the parent's memory
    torch.cuda.synchronize()
    dist.destroy_process_group()


def _run_world(fn, world: int, args: tuple, limit_s: float) -> None:
    """``repro_torch.testing.run_world`` within ``limit_s`` from now."""
    from repro_torch.testing import run_world
    run_world(fn, world, args, time.monotonic() + limit_s)


def sharded_path(x, wants: dict, values, keys, tally: Tally) -> dict:
    """The sharded engine on the card: a gloo world of WORLD ranks (NCCL
    refuses two ranks on one device), each holding 1/WORLD of the main
    path's and the grouped path's data, then an NCCL world of one rank.
    Every answer must equal the sort oracles bit for bit, and every rank
    must have launched each query's kernel.  Each rank's kernels at the
    path's shapes join ``tally``."""
    import tempfile
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    parent_bytes = torch.cuda.memory_allocated()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        _run_world(_sharded_rank, WORLD, (os.path.join(tmp, "store"), tmp,
                                          [x, values, keys]), 600)
        world_s = time.perf_counter() - t0
        ranks = []
        for r in range(WORLD):
            with open(os.path.join(tmp, f"rank{r}.json")) as fh:
                ranks.append(json.load(fh))
        _run_world(_nccl_rank, 1, (os.path.join(tmp, "nccl_store"), tmp,
                                   [x.reshape(WORLD, -1)[0]]), 300)
        with open(os.path.join(tmp, "nccl.json")) as fh:
            nccl = json.load(fh)
    torch.cuda.ipc_collect()
    for rec in ranks:
        for name, ok, what in rec["parity"]:
            tally.add(name, ok, what)
        for name, (kernel, oracle) in SHARDED_QUERIES.items():
            q = rec["queries"][name]
            want = _bits(wants[oracle]).reshape(-1).tolist()
            if q["answer_bits"] != want:
                raise AssertionError(f"sharded {name} on rank {rec['rank']}: "
                                     f"answer differs from the sort oracle")
            if q["launches_per_query"].get(kernel, 0) <= 0:
                raise AssertionError(f"sharded {name}: rank {rec['rank']} "
                                     f"launched no {kernel}")
    if not (nccl["exact"] and nccl["exact_full_sort"]):
        raise AssertionError("the NCCL world's answers differ from the sort")
    if nccl["collectives"]["host_copies"] or not (
            nccl["collectives"]["all_gather"]
            and nccl["collectives"]["all_reduce"]
            and nccl["collectives"]["all_to_all"]):
        raise AssertionError(f"NCCL world: collectives {nccl['collectives']}")
    rank0 = ranks[0]
    return {
        "world": WORLD, "backend": "gloo, CUDA tensors copied through host "
        "memory", "shard_values": x.numel() // WORLD, "n": x.numel(),
        "eps": EPS, "world_wall_s": world_s,
        "parent_allocated_bytes": parent_bytes,
        "queries": {name: {
            "median_s_rank0": q["median_s"], "runs_s_rank0": q["runs_s"],
            "median_s_slowest_rank": max(rec["queries"][name]["median_s"]
                                         for rec in ranks),
            "launches_per_query_each_rank": [
                rec["queries"][name]["launches_per_query"] for rec in ranks],
            "collectives_per_query_rank0": q["collectives_per_query"]}
            for name, q in rank0["queries"].items()},
        "phases_s_rank0": rank0["phases_s"],
        "profiles_rank0": rank0["profiles"],
        "kernels_alone_rank0": rank0["kernels_alone"],
        "peak_memory_bytes_each_rank": [rec["peak_memory_bytes"]
                                        for rec in ranks],
        "parity_at_path_shapes": {
            name: "{}/{}".format(
                sum(ok for rec in ranks for kn, ok, _ in rec["parity"]
                    if kn == name),
                sum(kn == name for rec in ranks for kn, _, _ in rec["parity"]))
            for name, _ in SHARDED_QUERIES.values()},
        "nccl_world_of_one": nccl}


# ---------------------------------------------------------------------------
# 9. the serving path: a dense model's prefill and decode, calibrated
# ---------------------------------------------------------------------------


def _tapped_calibrator(**kw):
    """A ``StreamingCalibrator`` that also keeps each observed logits
    tensor (the oracle sorts them all afterwards)."""
    from repro_torch.launch import StreamingCalibrator

    class Tap(StreamingCalibrator):
        def __init__(self):
            super().__init__(SERVE_Q, device="cuda", **kw)
            self.seen = []

        def observe_many(self, named):
            self.seen.append(named["logits"])
            super().observe_many(named)

    return Tap()


def _scale_query(cal, expect_fused: bool) -> tuple:
    """One ``scale`` with every count zeroed just before it; a fused
    calibrator must launch ``fused_select`` once per ring chunk of the
    stream and sort no sketch."""
    svc = cal.service
    cal.flush()
    chunks = len(svc._chunks_for(svc._names["logits"]))
    expect = {"fused_select": chunks} if expect_fused else None
    got, counts = _counted(lambda: cal.scale("logits"), 0, expect)
    if expect_fused and counts["launches"].get("fused_select", 0) < 1:
        raise AssertionError("the warm scale launched no fused_select")
    counts["ring_chunks"] = chunks
    return got, counts


def _prefill_bound_s(cfg, B: int, S: int, cache_len: int) -> float:
    """Least time of one prefill at the card's peak rates: the bf16 matmuls
    (every layer's weights at each of the B x S positions, the head at the
    last one; a moe layer's experts over their padded (E, cap) buffers, as
    the reference computes them; a vision_stub's patch projection) at the
    bf16 rate, and the f32 attention scores and sums over the cache (the
    direct path), a moe layer's f32 router and a mamba layer's chunk scan
    (its four f32 products, over the chunks the prompt pads to) at the f32
    rate.  A sliding-window config's cache is a ring of min(cache_len,
    window) slots, and the attention runs over those.  A hybrid's shared
    block counts once per group.  An
    encoder-decoder adds its encoder's layers over the B x Sf frames (Sf =
    S // enc_seq_divisor), each decoder layer's cross Q/O projections over
    the B x S tokens and cross K/V projections over the frames (bf16), and
    the f32 scores and sums of the cross-attention (S x Sf) and of the
    encoder's self-attention (Sf x Sf)."""
    from repro_torch.launch import roofline
    from repro_torch.models import moe

    if cfg.swa_window:
        cache_len = min(cache_len, cfg.swa_window)
    D, F, L, T = cfg.d_model, cfg.d_ff, cfg.n_layers, B * S
    NH, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    matmul, f32 = 2 * D * cfg.vocab * B, 0
    if cfg.family in ("ssm", "hybrid"):
        d_in, N, H, hd = (cfg.d_inner, cfg.ssm_state, cfg.ssm_heads,
                          cfg.ssm_head_dim)
        cl = min(cfg.ssm_chunk, S)
        chunks = -(-S // cl)
        matmul += 2 * L * T * (D * (2 * d_in + 2 * N + H) + d_in * D)
        f32 += 2 * L * B * chunks * (cl * cl * N + cl * cl * H * hd
                                     + 2 * cl * H * hd * N)
        if cfg.family == "ssm":
            return matmul / roofline.PEAK_FLOPS + f32 / roofline.PEAK_FLOPS_F32
        L = cfg.n_layers // cfg.hybrid_attn_every
    layer = D * (NH + 2 * KV) * dh + NH * dh * D
    if cfg.family != "moe" or cfg.moe_dense_residual:
        layer += (3 if cfg.mlp_type == "swiglu" else 2) * D * F
    matmul += 2 * L * layer * T
    f32 += 4 * L * B * NH * S * cache_len * dh
    if cfg.family == "moe":
        E = cfg.moe_experts
        matmul += 2 * L * E * moe.capacity(T, cfg) * 3 * D * F
        f32 += 2 * L * T * D * E
    if cfg.modality == "vision_stub":
        matmul += 2 * B * cfg.frontend_len * D * D
    if cfg.is_encdec:
        E, Sf = cfg.enc_layers, S // cfg.enc_seq_divisor
        matmul += 2 * E * layer * B * Sf
        matmul += 2 * L * (2 * D * NH * dh * T + 2 * D * KV * dh * B * Sf)
        f32 += 4 * L * B * NH * S * Sf * dh + 4 * E * B * NH * Sf * Sf * dh
    return matmul / roofline.PEAK_FLOPS + f32 / roofline.PEAK_FLOPS_F32


def _long_prompt(params, cfg, toks: torch.Tensor,
                 keep_cache: bool = False):
    """The blockwise attention at full width: the (B, S) prompts ``toks``,
    past ``q_block * kv_block * 2`` scores a head (with the config's
    window, if any).  The first layer's attention, blockwise against the
    direct path on the first prompt (f32, at most 1e-5 of max |out|) and
    its live memory at the whole batch, which must stay within the f32
    copies of its operands and eight kv steps' scores, as one q block at a
    time gives; then the whole prefill, its time and peak memory.  With
    ``keep_cache``, (that dict, the prefill's cache)."""
    from repro_torch.models import layers, model

    B, S = toks.shape
    NH, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    if S * S <= cfg.attn_q_block * cfg.attn_kv_block * 2:
        raise AssertionError("serve long prompt: not the blockwise path")
    x, pos, _ = model._embed_inputs(params.p, {"tokens": toks}, cfg)
    p = params.blocks[0].p
    h = layers.norm(x, p, cfg, "ln1")
    q = layers.apply_rope((h @ p["wq"]).reshape(B, S, NH, dh), pos,
                          cfg.rope_theta).float()
    k = layers.apply_rope((h @ p["wk"]).reshape(B, S, KV, dh), pos,
                          cfg.rope_theta).float()
    v = (h @ p["wv"]).reshape(B, S, KV, dh).float()
    del x, h
    kw = dict(window=cfg.swa_window, q_block=cfg.attn_q_block,
              kv_block=cfg.attn_kv_block)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    blockwise = layers.attention(q, k, v, pos, pos, **kw)
    torch.cuda.synchronize()
    attn_live = torch.cuda.max_memory_allocated() - before
    # k and v repeated to NH heads, the padded f32 q, k and v, and out
    operands = 6 * q.numel() * 4
    scores = B * NH * cfg.attn_q_block * cfg.attn_kv_block * 4
    if attn_live > operands + 8 * scores:
        raise AssertionError(f"serve long prompt: the blockwise attention "
                             f"held {attn_live} bytes, past {operands} of "
                             f"operands and 8 x {scores} of scores")
    direct = layers.attention(q[:1], k[:1], v[:1], pos[:1], pos[:1],
                              window=cfg.swa_window, q_block=S, kv_block=S)
    err = float((blockwise[:1] - direct).abs().max() / direct.abs().max())
    if not err <= 1e-5:
        raise AssertionError(f"serve long prompt: blockwise attention is "
                             f"{err} of max |out| off the direct path")
    del q, k, v, blockwise, direct
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    (logits, cache), prefill_s = _sync_time(
        lambda: model.prefill(params, {"tokens": toks}, cfg))
    peak = torch.cuda.max_memory_allocated() - before
    if logits.shape != (B, cfg.vocab) or not torch.isfinite(logits).all():
        raise AssertionError("serve long prompt: bad logits")
    cache_bytes = sum(t.numel() * t.element_size() for t in cache.values())
    out = {"batch": B, "prompt_len": S, "attention_rel_err": err,
           "attention_live_bytes": attn_live,
           "attention_live_bound_bytes": operands + 8 * scores,
           "prefill_s": prefill_s, "prefill_peak_above_weights_bytes": peak,
           "kv_cache_bytes": cache_bytes}
    if keep_cache:
        return out, cache
    del logits, cache
    torch.cuda.empty_cache()
    return out


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max() / want.abs().max())


def _decode_gate(what: str, step, full, f32) -> dict:
    """Decode's logits against prefill(S + 1)'s and each against the f32
    evaluation, with ``serve_path``'s gate: decode at most 1.5 x as far
    from f32 as the prefill; the decode-vs-prefill gap beside the JAX
    test's 5e-2."""
    for t in (step, full, f32):
        if t.shape != step.shape or not torch.isfinite(t).all():
            raise AssertionError(f"{what}: bad logits {tuple(t.shape)}")
    errs = {"decode_vs_prefill": _rel_err(step, full),
            "decode_vs_f32": _rel_err(step, f32),
            "prefill_vs_f32": _rel_err(full, f32)}
    errs["decode_vs_prefill_within_5e-2"] = errs["decode_vs_prefill"] <= 5e-2
    if not errs["decode_vs_f32"] <= 1.5 * errs["prefill_vs_f32"]:
        raise AssertionError(f"{what}: decode is {errs['decode_vs_f32']} of "
                             f"the logit scale off the f32 evaluation, more "
                             f"than 1.5 x the prefill's "
                             f"{errs['prefill_vs_f32']}")
    return errs


@torch.no_grad()
def _f32_logits(params, batch, cfg) -> torch.Tensor:
    """prefill's last logits for ``batch`` with the same weights in f32 (the
    reference's model at ``param_dtype="float32"``): each layer's weights
    are cast as it runs (no f32 copy of the model), and every activation is
    f32, the patch embeddings and the moe routing included; a mamba layer
    runs its chunked scan (whose intra-chunk product rounds its operands
    to bf16 at any param dtype, as the reference's does); an
    encoder-decoder runs its encoder (non-causal, then ``enc_norm``) and
    the cross-attention over its f32 output."""
    from repro_torch.models import layers, model, ssm

    f32 = dataclasses.replace(cfg, param_dtype="float32")
    top = {name: w.float() for name, w in params.p.items()}
    x, pos, pos3 = model._embed_inputs(top, batch, f32)

    def run(block, x, **kw):
        p = {name: w.float() for name, w in block.p.items()}
        if isinstance(block, model.MambaBlock):
            return x + ssm.ssd_forward(p, layers.rmsnorm(x, p["norm"]), f32)
        kw.setdefault("positions", pos)
        return model.block_fn(p, x, f32, positions3=pos3, **kw)[0]

    if cfg.is_encdec:
        frames = batch["frames"].float()
        B, Sf, _ = frames.shape
        enc_pos = torch.arange(Sf, dtype=torch.int32,
                               device=frames.device).expand(B, Sf)
        enc = frames
        for block in params.enc_blocks:
            enc = run(block, enc, positions=enc_pos, causal=False)
        enc_out = layers.rmsnorm(enc, top["enc_norm"])
        del enc
        for block in params.dec_blocks:
            x = run(block, x, enc_out=enc_out)
    elif cfg.family == "hybrid":
        for group in params.mamba:
            for block in group:
                x = run(block, x)
            x = run(params.shared, x)
    else:
        for block in params.blocks:
            x = run(block, x)
    return (layers.norm(x[:, -1], top, f32, "final_norm")
            @ top["head"]).float()


@torch.no_grad()
def _scan_check(params, batch, cfg) -> dict:
    """The first mamba layer's chunked ``ssd_forward`` on the prefill's
    input at full width against the sequential ``ssd_reference`` (one
    recurrent step a position): within 1e-2 of max |y|, the JAX test's
    bound (``tests/test_models.py``; the intra-chunk product rounds its
    operands to bf16)."""
    from repro_torch.models import layers, model, ssm

    block = (params.mamba[0][0] if cfg.family == "hybrid"
             else params.blocks[0])
    x, _, _ = model._embed_inputs(params.p, batch, cfg)
    xn = layers.rmsnorm(x, block.p["norm"])
    (chunked, chunked_s) = _sync_time(lambda: ssm.ssd_forward(block.p, xn,
                                                              cfg))
    sequential, sequential_s = _sync_time(
        lambda: ssm.ssd_reference(block.p, xn, cfg))
    err = _rel_err(chunked.float(), sequential.float())
    if not err <= 1e-2:
        raise AssertionError(f"{cfg.name}: the chunked scan is {err} of max "
                             f"|y| off the recurrence")
    return {"positions": x.shape[1], "chunk": cfg.ssm_chunk, "rel_err": err,
            "tolerance": 1e-2, "chunked_s": chunked_s,
            "sequential_s": sequential_s}


def serve_path(seed: int, tally) -> tuple:
    """granite-8b at its published width, weights from ``--seed``:
    SERVE_B prompts of SERVE_PROMPT tokens, SERVE_GEN greedy tokens each,
    with exact int8 calibration of the logits (streaming, fused, plain and
    threaded) and of the K cache (one-shot, per tensor and per channel),
    each scale equal bit for bit to a sort on the card."""
    from repro_torch.configs import get_config
    from repro_torch.core import local_ops, sketch as sk
    from repro_torch.kernels import fused_select as fs, ref
    from repro_torch.launch import StreamingCalibrator, roofline, serve
    from repro_torch.models import model

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(SERVE_ARCH)
    B, S, G = SERVE_B, SERVE_PROMPT, SERVE_GEN
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    tokens = torch.randint(0, cfg.vocab, (B, S + 1), generator=gen,
                           device="cuda", dtype=torch.int32)
    prompts = tokens[:, :S]
    at_s = torch.full((B,), S, dtype=torch.int32, device="cuda")

    # decode after prefill(S) against prefill(S + 1) on the served bf16
    # weights, and each of the two against the same weights in f32
    params, init_s = _sync_time(lambda: model.init_params(cfg, seed,
                                                          device="cuda"))
    _, cache = model.prefill(params, {"tokens": prompts}, cfg, cache_len=S + G)
    step, cache = model.decode_step(params, tokens[:, S:], cache, at_s, cfg)
    full, kv = model.prefill(params, {"tokens": tokens}, cfg, cache_len=S + G)
    if not (torch.isfinite(step).all() and torch.isfinite(full).all()):
        raise AssertionError("serve: non-finite logits")
    if step.shape != (B, cfg.vocab) or step.dtype != torch.float32:
        raise AssertionError(f"serve: logits {tuple(step.shape)} {step.dtype}")
    f32 = _f32_logits(params, {"tokens": tokens}, cfg)
    consistency = _decode_gate("serve", step, full, f32)
    del step, full, f32
    n_params = sum(w.numel() for w in params.parameters())
    weight_bytes = sum(w.numel() * w.element_size()
                       for w in params.parameters())
    cache_bytes = sum(t.numel() * t.element_size() for t in cache.values())
    _, prefill_s = _median_s(lambda: model.prefill(
        params, {"tokens": prompts}, cfg, cache_len=S + G))
    profiles = {"decode_step": _profile(lambda: model.decode_step(
        params, tokens[:, S:], cache, at_s, cfg))}
    del cache
    torch.cuda.empty_cache()

    # generate alone, with a fused calibrator and with a threaded one, in
    # turns (no warm-up round: the prefill and the decode step ran above,
    # and the median sets a slower first round aside); each calibrated
    # run gets a fresh calibrator, and the last round's are queried below
    def run(cal=None):
        return serve.generate(cfg, params, prompts, gen_len=G,
                              calibrator=cal)

    runs = {"alone": [], "sync": [], "threaded": [], "threaded_flush": []}
    toks, cal, threaded = None, None, None
    for _ in range(SERVE_ROUNDS):
        got, t = _sync_time(run)
        runs["alone"].append(t)
        if toks is not None and not torch.equal(got, toks):
            raise AssertionError("serve: greedy tokens changed between runs")
        toks = got
        cal = _tapped_calibrator(fused=True)
        got, t = _sync_time(lambda: run(cal))
        runs["sync"].append(t)
        if not torch.equal(got, toks):
            raise AssertionError("serve: tokens changed with a calibrator")
        if threaded is not None:
            threaded.close()
        threaded = StreamingCalibrator(SERVE_Q, fused=True, ingest_threads=4,
                                       device="cuda")
        got, t = _sync_time(lambda: run(threaded))
        runs["threaded"].append(t)
        runs["threaded_flush"].append(_sync_time(threaded.flush)[1])
        if not torch.equal(got, toks):
            raise AssertionError("serve: tokens changed with a threaded "
                                 "calibrator")
    gen_s, gen_sync_s, gen_threaded_s, threaded_flush_s = (
        statistics.median(runs[k]) for k in ("alone", "sync", "threaded",
                                             "threaded_flush"))
    plain = StreamingCalibrator(SERVE_Q, fused=False, device="cuda")
    for logits in cal.seen:
        plain.observe_many({"logits": logits})

    # the streaming scales against a sort of every observed |logit|
    observed = torch.cat([t.reshape(-1) for t in cal.seen]).abs()
    n = observed.numel()
    k = local_ops.target_rank(n, SERVE_Q)
    want = torch.sort(observed).values[k - 1].clone()
    del observed
    per_query, scales = {}, {}
    for name, c, fused in (("scale_fused", cal, True),
                           ("scale_threaded", threaded, True),
                           ("scale_plain", plain, False)):
        if c.observed("logits") != n:
            raise AssertionError(f"serve {name}: observed "
                                 f"{c.observed('logits')} != {n}")
        got, per_query[name] = _scale_query(c, fused)
        _check_bits(f"serve {name}", got, want)
        again, scales[name + "_median_s"] = _median_s(
            lambda: c.scale("logits"))
        _check_bits(f"serve {name} again", again, want)
    approx, scales["approx_scale_median_s"] = _median_s(
        lambda: cal.approx_scale("logits"))
    warm = _warm_phases(cal.service, "logits", SERVE_Q)
    profiles["scale_fused"] = _profile(lambda: cal.scale("logits"))

    # fused_select at the serve's shapes against its plain version
    svc = cal.service
    slot = svc._names["logits"]
    chunk = svc._chunks_for(slot)[0][None]
    pivot = sk.sketch_query_rank(svc._row_state(slot), k)
    cap = min(chunk.shape[1], warm["cap"])
    tally.add("fused_select", _same_bits(fs.fused_select(chunk, pivot, cap),
                                         ref.fused_select_ref(chunk, pivot,
                                                              cap)),
              f"serve chunk 1 x {chunk.shape[1]} cap={cap}")
    for c in (cal, threaded, plain):
        c.close()
    if threaded.pool._fold_thread.is_alive():
        raise AssertionError("serve: the ingest pool's fold thread lives on")

    # one-shot: the K cache of every layer, and the last layer's channels
    kc = kv["k"]
    del kv
    one_shot, _ = _one_shot_k_cache(kc)
    torch.cuda.empty_cache()
    chans = kc[-1].reshape(B * (S + G), cfg.n_kv_heads * cfg.d_head)
    got, one_shot["scales_s"] = _sync_time(
        lambda: serve.calibrate_int8_scales(chans, axis=-1))
    one_shot["channels"], one_shot["values_per_channel"] = (chans.shape[1],
                                                           chans.shape[0])
    _check_bits("calibrate_int8_scales", got,
                torch.sort(chans.float().abs(), dim=0).values[
                    local_ops.target_rank(chans.shape[0], SERVE_Q) - 1])
    peak = torch.cuda.max_memory_allocated()
    del kc, chans, cal, threaded, plain
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    long_prompt = _long_prompt(params, cfg, torch.randint(
        0, cfg.vocab, (SERVE_LONG_B, SERVE_LONG_PROMPT), generator=gen,
        device="cuda", dtype=torch.int32))
    del params
    torch.cuda.empty_cache()

    decode_s = (gen_s - prefill_s) / (G - 1)
    steps = G                                   # the prefill's and 63 decodes'
    return {
        "arch": SERVE_ARCH, "params": n_params, "weight_bytes": weight_bytes,
        "batch": B, "prompt_len": S, "gen_len": G, "cache_len": S + G,
        "kv_cache_bytes": cache_bytes, "init_s": init_s,
        "consistency_rel_err": consistency,
        "prefill_median_s": prefill_s,
        "prefill_bound_s": _prefill_bound_s(cfg, B, S, S + G),
        "generate_median_s": gen_s, "generate_runs_s": runs,
        "decode_s_per_step": decode_s,
        "decode_bound_s_per_step": (weight_bytes + cache_bytes)
        / roofline.HBM_BW,
        "tokens_per_s": B * G / gen_s,
        "generate_calibrated_sync_median_s": gen_sync_s,
        "generate_calibrated_threaded_median_s": gen_threaded_s,
        "threaded_flush_after_median_s": threaded_flush_s,
        "calibration_s_per_step_sync": (gen_sync_s - gen_s) / steps,
        "calibration_s_per_step_threaded": (gen_threaded_s - gen_s) / steps,
        "observed_values": n, "q": SERVE_Q, "scale": float(want),
        "approx_scale": float(approx), **scales, "per_query": per_query,
        "warm_scale": warm, "one_shot": one_shot,
        "peak_memory_bytes": peak, "allocated_before_bytes": base,
        "long_prompt": long_prompt, "profiles": profiles,
        "wall_s": time.perf_counter() - t_phase,
    }, per_query


# ---------------------------------------------------------------------------
# 10. the moe and vlm families served at full width, calibrated
# ---------------------------------------------------------------------------


class _MoeTap:
    """Wraps ``repro_torch.models.moe.moe_block`` while active: each call
    records the experts its last position picks (B, k) and how many of
    them it drops (B,), each expert's assignments (E,) and the capacity,
    from ``route`` and ``dispatch`` on the same input (extra work, so taps
    stay off the timed runs)."""

    def __init__(self):
        from repro_torch.models import moe
        self.moe, self.calls = moe, []

    def __enter__(self):
        moe, block = self.moe, self.moe.moe_block

        def tapped(p, x, cfg):
            B, S, D = x.shape
            T = B * S
            _, _, top_i = moe.route(p, x.reshape(T, D), cfg)
            cap = moe.capacity(T, cfg)
            d = moe.dispatch(top_i, cap, cfg.moe_experts)
            keep = torch.empty_like(d.keep).scatter_(0, d.order, d.keep)
            self.calls.append({
                "picks": top_i.view(B, S, -1)[:, -1].sort(-1).values,
                "dropped_last": (~keep.view(B, S, -1)[:, -1]).sum(-1),
                "count": d.count, "cap": cap})
            return block(p, x, cfg)

        self.block, moe.moe_block = block, tapped
        return self

    def __exit__(self, *exc):
        self.moe.moe_block = self.block

    def take(self) -> list:
        out, self.calls = self.calls, []
        return out


def _routing_differs(a: list, b: list) -> torch.Tensor:
    """(B,) number of layers whose last-position experts differ."""
    return sum((x["picks"] != y["picks"]).any(-1).long()
               for x, y in zip(a, b))


def _vision_extras(cfg, B: int, n: int, gen) -> dict:
    """N(0, 1) f32 patch embeddings at the first ``frontend_len`` positions
    (a square grid: (t, h, w) = (0, i // side, i % side)), text position j
    after them at (j, j, j), as (3, B, n) ``positions3``."""
    F = cfg.frontend_len
    side = math.isqrt(F)
    i = torch.arange(n, dtype=torch.int32, device="cuda")
    p3 = torch.stack([i, i, i])
    p3[0, :F] = 0
    p3[1, :F] = i[:F] // side
    p3[2, :F] = i[:F] % side
    return {"patch_embeds": torch.randn((B, F, cfg.d_model), generator=gen,
                                        device="cuda"),
            "positions3": p3[:, None].expand(3, B, n).contiguous()}


@torch.no_grad()
def _moe_formula(params, batch, cfg) -> dict:
    """The first layer's ``moe_block`` at full width on the prefill's
    tokens against a direct evaluation with the same routing: every expert
    on every token (E x T rows of bf16 hidden state), then each token's
    kept experts by their gates, summed in f32.  Within 2e-2 of max |y|
    (the CPU tests' bf16 share: both round each expert's output to bf16,
    in other tilings, and the layer adds its gated terms in bf16).  Also
    the router's product against f64: within 1e-5 of max |logit| (TF32
    would give about 1e-3)."""
    import torch.nn.functional as F
    from repro_torch.models import layers, model, moe

    p = params.blocks[0].p
    x, pos, pos3 = model._embed_inputs(params.p, batch, cfg)
    h, _ = layers.attn_block(p, layers.norm(x, p, cfg, "ln1"), cfg,
                             positions=pos, positions3=pos3)
    xn = layers.norm(x + h, p, cfg, "ln2")
    del x, h
    y, _ = moe.moe_block(p, xn, cfg)
    B, S, D = xn.shape
    T, E = B * S, cfg.moe_experts
    xt = xn.reshape(T, D)
    logits = xt.float() @ p["router"]
    exact = xt.double() @ p["router"].double()
    router_err = float((logits - exact).abs().max() / exact.abs().max())
    _, top_p, top_i = moe.route(p, xt, cfg)
    cap = moe.capacity(T, cfg)
    d = moe.dispatch(top_i, cap, E)
    keep = torch.empty_like(d.keep).scatter_(0, d.order, d.keep).view(T, -1)
    every = xt.expand(E, T, D)
    hid = F.silu(torch.bmm(every, p["we_gate"])) * torch.bmm(every,
                                                             p["we_up"])
    out = torch.bmm(hid, p["we_down"])                    # (E, T, D)
    hidden_bytes = hid.numel() * hid.element_size()
    del hid, every
    picked = out[top_i, torch.arange(T, device="cuda")[:, None]]
    want = (picked.float() * torch.where(keep, top_p, 0.0)[..., None]).sum(1)
    err = _rel_err(y.reshape(T, D).float(), want)
    del out, picked
    torch.cuda.empty_cache()
    if not err <= 2e-2:
        raise AssertionError(f"moe_block is {err} of max |y| off its formula")
    if not router_err <= 1e-5:
        raise AssertionError(f"the router's f32 product is {router_err} off "
                             f"f64: not full f32")
    return {"tokens": T, "capacity": cap, "rel_err": err, "tolerance": 2e-2,
            "router_rel_err_vs_f64": router_err,
            "dropped": int((~keep).sum()), "hidden_bytes": hidden_bytes,
            "direct_flop": 2 * 3 * E * T * D * cfg.d_ff}


def _consistency(params, cfg, batch, tokens, at_s, cache_len: int,
                 gate: bool) -> tuple:
    """Decode after prefill(S) against prefill(S + 1), and each against the
    same weights in f32 (``_f32_logits``): (errors, a moe model's routing
    record or None, the decode's cache).  A moe model's record counts, per
    layer and row, the last position's experts that differ between decode
    and prefill(S + 1) and between bf16 and f32, that position's
    assignments dropped in prefill(S + 1), and prefill(S)'s drops and
    expert loads.  With ``gate``, the decode must be no farther (1.5 x)
    from the f32 evaluation than the prefill is, over the rows whose last
    position takes the same experts in every layer in decode and prefill(S
    + 1) (all rows outside the moe family): a differing expert is a
    discrete change of that position's output, in both packages."""
    from repro_torch.models import model

    B, S = tokens.shape[0], tokens.shape[1] - 1
    with _MoeTap() as tap:
        _, cache = model.prefill(params, batch(S), cfg, cache_len=cache_len)
        prefill_calls = tap.take()
        step, cache = model.decode_step(params, tokens[:, S:], cache, at_s,
                                        cfg)
        step_calls = tap.take()
        full = model.prefill(params, batch(S + 1), cfg,
                             cache_len=cache_len)[0]
        full_calls = tap.take()
        f32 = _f32_logits(params, batch(S + 1), cfg)
        f32_calls = tap.take()
    for t in (step, full, f32):
        if t.shape != (B, cfg.vocab) or not torch.isfinite(t).all():
            raise AssertionError(f"{cfg.name}: bad logits {tuple(t.shape)}")
    errs = {"decode_vs_prefill": _rel_err(step, full),
            "decode_vs_f32": _rel_err(step, f32),
            "prefill_vs_f32": _rel_err(full, f32)}
    errs["decode_vs_prefill_within_5e-2"] = errs["decode_vs_prefill"] <= 5e-2
    rows = torch.ones(B, dtype=torch.bool, device="cuda")
    routing = None
    if cfg.family == "moe":
        differs = _routing_differs(step_calls, full_calls)
        rows = differs == 0
        routing = {
            "capacity_factor": cfg.moe_capacity_factor,
            "layers_x_rows": cfg.n_layers * B,
            "differ_decode_vs_prefill": int(differs.sum()),
            "differ_bf16_vs_f32": int(_routing_differs(full_calls,
                                                       f32_calls).sum()),
            "rows_routed_alike": int(rows.sum()),
            "last_position_dropped_in_prefill": int(sum(
                c["dropped_last"].sum() for c in full_calls)),
            "prefill_capacity": prefill_calls[0]["cap"],
            "prefill_dropped_per_layer": [
                int((c["count"] - c["cap"]).clamp(min=0).sum())
                for c in prefill_calls],
            "prefill_load_min_max_per_layer": [
                (int(c["count"].min()), int(c["count"].max()))
                for c in prefill_calls]}
        routing["prefill_dropped"] = sum(routing["prefill_dropped_per_layer"])
    if gate:
        if not rows.any():
            raise AssertionError(f"{cfg.name}: no row routes alike in "
                                 f"decode and prefill(S + 1)")
        scale = f32.abs().max()
        errs["rows_decode_vs_f32"] = float(
            (step[rows] - f32[rows]).abs().max() / scale)
        errs["rows_prefill_vs_f32"] = float(
            (full[rows] - f32[rows]).abs().max() / scale)
        if not errs["rows_decode_vs_f32"] <= 1.5 * errs["rows_prefill_vs_f32"]:
            raise AssertionError(
                f"{cfg.name}: decode is {errs['rows_decode_vs_f32']} of the "
                f"logit scale off the f32 evaluation, more than 1.5 x the "
                f"prefill's {errs['rows_prefill_vs_f32']}")
    return errs, routing, cache


def _one_shot_k_cache(kc: torch.Tensor) -> tuple:
    """``serve.calibrate_int8_scale`` over the K cache of every layer (its
    unwritten slots hold zeros) against a sort of every |value| on the
    card, bit for bit: (its record, the launches of one call with every
    count zeroed just before it)."""
    from repro_torch.core import local_ops
    from repro_torch.launch import serve

    got, counts = _counted(lambda: serve.calibrate_int8_scale(kc))
    again, scale_s = _median_s(lambda: serve.calibrate_int8_scale(kc))
    flat = kc.float().abs().reshape(-1)
    want = torch.sort(flat).values[local_ops.target_rank(flat.numel(),
                                                         SERVE_Q) - 1]
    del flat
    _check_bits("calibrate_int8_scale", got, want)
    _check_bits("calibrate_int8_scale again", again, want)
    return {"k_cache_values": kc.numel(), "scale": float(want),
            "scale_median_s": scale_s,
            "scale_launches": counts["launches"]}, counts


def family_serve_path(name: str, arch: str, seed: int, tally,
                      one_shot: bool = False,
                      rounds: int = SERVE_ROUNDS) -> tuple:
    """``arch`` (the moe, vlm, ssm, hybrid or audio family, or a dense
    config) at its published width and depth, weights from ``--seed``:
    SERVE_B prompts of
    SERVE_PROMPT positions (a vision_stub's first ``frontend_len`` are
    patch embeddings; an encoder-decoder's encoder reads SERVE_PROMPT //
    ``enc_seq_divisor`` N(0, 1) frames a prompt, whole for every prefix),
    SERVE_GEN greedy tokens each (``rounds`` rounds of ``generate`` alone
    and with a calibrator), the logits calibrated by a
    fused ``StreamingCalibrator`` whose warm ``scale`` must equal a sort on
    the card bit for bit.  A mamba model also holds its first layer's
    chunked scan against the recurrence (``_scan_check``).  With
    ``one_shot``, the decode's K cache of every layer is kept and, once
    the generates are done, calibrated in one shot (``_one_shot_k_cache``).
    Every launch count is zeroed at the start and read at the end;
    ``fused_select`` must have launched."""
    import repro_torch.kernels as K
    from repro_torch import pytree
    from repro_torch.configs import get_config
    from repro_torch.core import local_ops, sketch as sk
    from repro_torch.kernels import fused_select as fs, ref
    from repro_torch.launch import roofline, serve
    from repro_torch.models import model

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    free_at_start = torch.cuda.mem_get_info()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    cfg = get_config(arch)
    is_moe = cfg.family == "moe"
    B, S, G = SERVE_B, SERVE_PROMPT, SERVE_GEN
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    tokens = torch.randint(0, cfg.vocab, (B, S + 1), generator=gen,
                           device="cuda", dtype=torch.int32)
    extras = (_vision_extras(cfg, B, S + 1, gen)
              if cfg.modality == "vision_stub" else {})
    if cfg.is_encdec:
        # N(0, 1), not the CLI's zeros: zero frames would zero the
        # encoder's output and every cross K/V, hiding the cross path
        extras["frames"] = torch.randn(
            (B, S // cfg.enc_seq_divisor, cfg.d_model), generator=gen,
            device="cuda")

    def batch(n: int) -> dict:
        out = {"tokens": tokens[:, :n]}
        for key, t in extras.items():
            out[key] = t[..., :n] if key == "positions3" else t
        return out

    prompts = tokens[:, :S]
    prompt_extras = {key: t for key, t in batch(S).items() if key != "tokens"}
    at_s = torch.full((B,), S, dtype=torch.int32, device="cuda")
    params, init_s = _sync_time(lambda: model.init_params(cfg, seed,
                                                          device="cuda"))

    # decode after prefill(S) against prefill(S + 1), each against the same
    # weights in f32: as served, and for a moe model also with every
    # expert taking every token (as a decode step's capacity does), where
    # the gate applies
    consistency, routing, cache = _consistency(params, cfg, batch, tokens,
                                               at_s, S + G, gate=not is_moe)
    if is_moe:
        E, k = cfg.moe_experts, cfg.moe_top_k
        dropless = dataclasses.replace(cfg, moe_capacity_factor=E / k)
        consistency["dropless"], routing["dropless"], _ = _consistency(
            params, dropless, batch, tokens, at_s, S + G, gate=True)
    moe_formula = _moe_formula(params, batch(S), cfg) if is_moe else None
    scan = (_scan_check(params, batch(S), cfg)
            if cfg.family in ("ssm", "hybrid") else None)
    n_params = sum(w.numel() for w in params.parameters())
    weight_bytes = sum(w.numel() * w.element_size()
                       for w in params.parameters())
    # what a decode step reads of the weights: an encoder-decoder's decoder
    # reads neither the encoder nor the cross K/V projections (prefill
    # filled the cross cache with their products)
    unread = []
    if cfg.is_encdec:
        unread = [params.p["enc_norm"], *(w for b in params.enc_blocks
                                          for w in b.parameters())]
        unread += [b.p[name] for b in params.dec_blocks
                   for name in ("wk_c", "wv_c")]
    decode_weight_bytes = weight_bytes - sum(w.numel() * w.element_size()
                                             for w in unread)
    cache_bytes = sum(t.numel() * t.element_size()
                      for t in pytree.leaves(cache))
    # a decode step rewrites the whole recurrent state (ssm and conv)
    state = (cache if cfg.family == "ssm" else cache.get("mamba", {}))
    state_bytes = sum(t.numel() * t.element_size()
                      for t in pytree.leaves(state))
    _, prefill_s = _median_s(lambda: model.prefill(
        params, batch(S), cfg, cache_len=S + G))
    profile = _profile(lambda: model.decode_step(params, tokens[:, S:],
                                                 cache, at_s, cfg))
    k_cache = cache["k"] if one_shot else None
    del cache
    torch.cuda.empty_cache()

    # generate alone and with a fused calibrator, in turns (as
    # serve_path's); the tokens must not change
    def run(cal=None):
        return serve.generate(cfg, params, prompts, gen_len=G,
                              extras=prompt_extras, calibrator=cal)

    runs = {"alone": [], "sync": []}
    toks, cal = None, None
    for _ in range(rounds):
        got, t = _sync_time(run)
        runs["alone"].append(t)
        if toks is not None and not torch.equal(got, toks):
            raise AssertionError(f"{name}: greedy tokens changed between "
                                 f"runs")
        toks = got
        cal = _tapped_calibrator(fused=True)
        got, t = _sync_time(lambda: run(cal))
        runs["sync"].append(t)
        if not torch.equal(got, toks):
            raise AssertionError(f"{name}: tokens changed with a calibrator")
    gen_s, gen_sync_s = (statistics.median(runs[k]) for k in runs)
    launches = {k: c for k, c in K.launches().items() if c}

    # the warm scale against a sort of every observed |logit|
    observed = torch.cat([t.reshape(-1) for t in cal.seen]).abs()
    n = observed.numel()
    k = local_ops.target_rank(n, SERVE_Q)
    want = torch.sort(observed).values[k - 1].clone()
    del observed
    if cal.observed("logits") != n:
        raise AssertionError(f"{name}: observed {cal.observed('logits')} "
                             f"!= {n}")
    got, per_query = _scale_query(cal, True)
    _check_bits(f"{name} scale", got, want)
    for kname, c in per_query["launches"].items():
        launches[kname] = launches.get(kname, 0) + c
    if launches.get("fused_select", 0) < 1:
        raise AssertionError(f"{name}: fused_select never launched")
    again, scale_s = _median_s(lambda: cal.scale("logits"))
    _check_bits(f"{name} scale again", again, want)

    # fused_select at this phase's chunk against its plain version
    svc = cal.service
    slot = svc._names["logits"]
    chunk = svc._chunks_for(slot)[0][None]
    pivot = sk.sketch_query_rank(svc._row_state(slot), k)
    cap = min(chunk.shape[1], _warm_phases(svc, "logits", SERVE_Q)["cap"])
    tally.add("fused_select", _same_bits(fs.fused_select(chunk, pivot, cap),
                                         ref.fused_select_ref(chunk, pivot,
                                                              cap)),
              f"{name} chunk 1 x {chunk.shape[1]} cap={cap}")
    cal.close()
    del cal, svc, chunk
    torch.cuda.empty_cache()
    queries = {"scale_fused": per_query}
    one_shot_record = None
    if one_shot:
        one_shot_record, queries["one_shot"] = _one_shot_k_cache(k_cache)
        del k_cache
    peak = torch.cuda.max_memory_allocated()
    del params
    torch.cuda.empty_cache()

    decode_s = (gen_s - prefill_s) / (G - 1)
    return {
        "arch": arch, "family": cfg.family, "params": n_params,
        "param_count_formula": cfg.param_count(),
        "active_params_per_token": cfg.active_param_count(),
        "weight_bytes": weight_bytes, "batch": B, "prompt_len": S,
        "patch_positions": cfg.frontend_len if extras else 0,
        "frames": extras["frames"].shape[1] if cfg.is_encdec else 0,
        "gen_len": G, "cache_len": S + G, "kv_cache_bytes": cache_bytes,
        "recurrent_state_bytes": state_bytes,
        "init_s": init_s, "consistency_rel_err": consistency,
        "decode_gap_cpu": DECODE_GAP_CPU.get(arch),
        "routing": routing, "moe_formula": moe_formula, "scan_check": scan,
        "prefill_median_s": prefill_s,
        "prefill_bound_s": _prefill_bound_s(cfg, B, S, S + G),
        "generate_median_s": gen_s, "generate_runs_s": runs,
        "decode_s_per_step": decode_s,
        "decode_weight_bytes": decode_weight_bytes,
        "decode_bound_s_per_step": (decode_weight_bytes + cache_bytes
                                    + state_bytes) / roofline.HBM_BW,
        "decode_busy_share": profile.get("device_busy_share"),
        "tokens_per_s": B * G / gen_s,
        "generate_calibrated_sync_median_s": gen_sync_s,
        "calibration_s_per_step_sync": (gen_sync_s - gen_s) / G,
        "observed_values": n, "q": SERVE_Q, "scale": float(want),
        "scale_fused_median_s": scale_s, "per_query": per_query,
        "one_shot": one_shot_record,
        "phase_launches": launches, "peak_memory_bytes": peak,
        "allocated_before_bytes": base,
        "mem_get_info_at_start_bytes": free_at_start,
        "profile_decode_step": profile,
        "wall_s": time.perf_counter() - t_phase,
    }, queries


# ---------------------------------------------------------------------------
# 10b. a sliding-window model served through its ring; sampled decoding
# ---------------------------------------------------------------------------


def _ring_positions(W: int, last: int) -> torch.Tensor:
    """(W,) the position each slot of a ring holds once positions 0..last
    were written in order, position p at slot p % W: the newest p of each
    slot (the unwritten sentinel where none)."""
    from repro_torch.models import layers
    j = torch.arange(W, device="cuda")
    return torch.where(j <= last, last - (last - j) % W,
                       layers.UNWRITTEN).to(torch.int32)


class _SampledTap:
    """While active: ``model.prefill`` turns on
    ``torch.cuda.set_sync_debug_mode("error")`` as it returns, so that the
    rest of a ``generate`` (its decode steps and its draws) raises on a host
    sync; ``model.decode_step`` keeps the last cache it returns.  The mode
    is back to "default" on exit."""

    def __init__(self):
        from repro_torch.models import model
        self.model, self.cache = model, None

    def __enter__(self):
        self.prefill, self.decode = self.model.prefill, self.model.decode_step

        def prefill(*a, **kw):
            out = self.prefill(*a, **kw)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            return out

        def decode(*a, **kw):
            logits, self.cache = self.decode(*a, **kw)
            return logits, self.cache

        self.model.prefill, self.model.decode_step = prefill, decode
        return self

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode("default")
        self.model.prefill, self.model.decode_step = self.prefill, self.decode


def swa_serve_path(seed: int, tally) -> tuple:
    """h2o-danube-1.8b at its published width and depth, weights from
    ``--seed``, served through its ring of ``swa_window`` slots: (a)
    SERVE_B prompts of SWA_PROMPT tokens and SERVE_GEN greedy tokens, decode
    gated against prefill(S + 1) and f32 before the wrap and at SWA_WRAP_AT
    after it, the ring's slots after ``generate``, the warm ``scale`` of a
    fused calibrator against a sort; (b) prompts of SWA_LONG_PROMPT tokens,
    the blockwise attention against the direct path and decode after the
    ring took their last window; (c) sampled ``generate`` twice, with no
    host sync; (d) the windowed blockwise backward at full width."""
    import repro_torch.kernels as K
    from repro_torch.configs import get_config
    from repro_torch.core import local_ops, sketch as sk
    from repro_torch.kernels import fused_select as fs, ref
    from repro_torch.launch import roofline, serve
    from repro_torch.models import model

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    cfg = get_config(SWA_ARCH)
    W = cfg.swa_window
    B, S, G, at, SL = (SERVE_B, SWA_PROMPT, SERVE_GEN, SWA_WRAP_AT,
                       SWA_LONG_PROMPT)
    cache_len = S + G
    if not (S < W <= at < S + G - 1 and W < SL):
        raise AssertionError("swa serve: the shapes do not wrap the ring")
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    tokens = torch.randint(0, cfg.vocab, (B, at + 1), generator=gen,
                           device="cuda", dtype=torch.int32)
    prompts = tokens[:, :S]
    params, init_s = _sync_time(lambda: model.init_params(cfg, seed,
                                                          device="cuda"))
    n_params = sum(w.numel() for w in params.parameters())
    weight_bytes = sum(w.numel() * w.element_size()
                       for w in params.parameters())

    def batch(n: int) -> dict:
        return {"tokens": tokens[:, :n]}

    def position(p: int) -> torch.Tensor:
        return torch.full((B,), p, dtype=torch.int32, device="cuda")

    # (a) teacher-forced decode from prefill(S) through the wrap, gated at
    # S and at ``at`` against prefill(p + 1) and the f32 evaluation (no
    # cache, every query over its own window)
    _, cache = model.prefill(params, batch(S), cfg, cache_len=cache_len)
    if cache["k"].shape[2] != W:
        raise AssertionError(f"swa serve: a cache of {cache['k'].shape[2]} "
                             f"slots, not the ring's {W}")
    steps = {}
    for p in range(S, at + 1):
        logits, cache = model.decode_step(params, tokens[:, p:p + 1], cache,
                                          position(p), cfg)
        if p in (S, at):
            steps[p] = logits
    if not torch.equal(cache["pos"], _ring_positions(W, at).expand_as(
            cache["pos"])):
        raise AssertionError(f"swa serve: the ring after position {at} does "
                             f"not hold the newest position of each slot")
    consistency = {}
    for p, step in steps.items():
        full, _ = model.prefill(params, batch(p + 1), cfg,
                                cache_len=cache_len)
        f32 = _f32_logits(params, batch(p + 1), cfg)
        consistency[f"decode_at_{p}"] = _decode_gate(
            f"{SWA_ARCH} decode at {p}", step, full, f32)
        del full, f32
    del steps
    cache_bytes = sum(t.numel() * t.element_size() for t in cache.values())
    profile = _profile(lambda: model.decode_step(
        params, tokens[:, at:at + 1], cache, position(at + 1), cfg))
    del cache
    torch.cuda.empty_cache()
    # (SERVE_ROUNDS runs: a prefill here takes seconds)
    _, prefill_s = _median_s(lambda: model.prefill(
        params, batch(S), cfg, cache_len=cache_len), runs=SERVE_ROUNDS)

    # generate alone and with a fused calibrator, in turns (as the family
    # phases'); the tokens must not change
    def run(cal=None):
        return serve.generate(cfg, params, prompts, gen_len=G, calibrator=cal)

    runs = {"alone": [], "sync": []}
    toks, cal = None, None
    for _ in range(SERVE_ROUNDS):
        got, t = _sync_time(run)
        runs["alone"].append(t)
        if toks is not None and not torch.equal(got, toks):
            raise AssertionError("swa serve: greedy tokens changed between "
                                 "runs")
        toks = got
        cal = _tapped_calibrator(fused=True)
        got, t = _sync_time(lambda: run(cal))
        runs["sync"].append(t)
        if not torch.equal(got, toks):
            raise AssertionError("swa serve: tokens changed with a "
                                 "calibrator")
    gen_s, gen_sync_s = (statistics.median(runs[k]) for k in runs)
    launches = {k: c for k, c in K.launches().items() if c}

    # the warm scale against a sort of every observed |logit|
    observed = torch.cat([t.reshape(-1) for t in cal.seen]).abs()
    n = observed.numel()
    k = local_ops.target_rank(n, SERVE_Q)
    want = torch.sort(observed).values[k - 1].clone()
    del observed
    if cal.observed("logits") != n:
        raise AssertionError(f"swa serve: observed {cal.observed('logits')} "
                             f"!= {n}")
    got, per_query = _scale_query(cal, True)
    _check_bits("swa serve scale", got, want)
    for kname, c in per_query["launches"].items():
        launches[kname] = launches.get(kname, 0) + c
    again, scale_s = _median_s(lambda: cal.scale("logits"))
    _check_bits("swa serve scale again", again, want)
    svc = cal.service
    slot = svc._names["logits"]
    chunk = svc._chunks_for(slot)[0][None]
    pivot = sk.sketch_query_rank(svc._row_state(slot), k)
    cap = min(chunk.shape[1], _warm_phases(svc, "logits", SERVE_Q)["cap"])
    tally.add("fused_select", _same_bits(fs.fused_select(chunk, pivot, cap),
                                         ref.fused_select_ref(chunk, pivot,
                                                              cap)),
              f"swa_serve_path chunk 1 x {chunk.shape[1]} cap={cap}")
    cal.close()
    del cal

    # (c) sampled decoding twice from one seed, no host sync after the
    # prefill; the ring after the last step holds the newest positions
    sampled, sampled_s = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _SampledTap() as tap:
            got = serve.generate(cfg, params, prompts, gen_len=G,
                                 greedy=False, seed=seed + 3)
        torch.cuda.synchronize()
        sampled.append(got)
        sampled_s.append(time.perf_counter() - t0)
    if not torch.equal(sampled[0], sampled[1]):
        raise AssertionError("swa serve: sampled tokens differ under one seed")
    if not (int(sampled[0].min()) >= 0
            and int(sampled[0].max()) < cfg.vocab):
        raise AssertionError("swa serve: a sampled token out of the vocab")
    ring = tap.cache["pos"]
    if ring.shape[2] != W or not torch.equal(ring, _ring_positions(
            W, S + G - 2).expand_as(ring)):
        raise AssertionError("swa serve: the ring after generate does not "
                             "hold the newest position of each slot")
    ring_slots = {"width": ring.shape[2],
                  "slots_0_to_4": ring[0, 0, :5].tolist(),
                  "slots_29_to_33": ring[0, 0, 29:34].tolist()}
    del tap, ring

    # (b) prompts past the window: the blockwise attention against the
    # direct path, then decode at SL after prefill(SL) (the ring holds the
    # prompt's last window) against prefill(SL + 1)
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    long_toks = torch.randint(0, cfg.vocab, (B, SL + 1), generator=gen,
                              device="cuda", dtype=torch.int32)
    long_prompt, cache = _long_prompt(params, cfg, long_toks[:, :SL],
                                      keep_cache=True)
    if not torch.equal(cache["pos"], torch.arange(
            SL - W, SL, dtype=torch.int32, device="cuda").expand_as(
                cache["pos"])):
        raise AssertionError("swa serve: prefill past the window did not "
                             "write its last window")
    step, cache = model.decode_step(params, long_toks[:, SL:], cache,
                                    position(SL), cfg)
    full, _ = model.prefill(params, {"tokens": long_toks}, cfg)
    f32 = _f32_logits(params, {"tokens": long_toks}, cfg)
    consistency[f"decode_at_{SL}"] = _decode_gate(
        f"{SWA_ARCH} decode at {SL}", step, full, f32)
    del step, full, f32
    _, long_decode_s = _median_s(lambda: model.decode_step(
        params, long_toks[:, SL:], cache, position(SL), cfg))
    del cache
    peak = torch.cuda.max_memory_allocated()

    # (d) the windowed blockwise backward on the first layer's q, k, v of
    # the first long prompt, with the model freed
    q, k_, v, pos = _first_layer_qkv(params, cfg, long_toks[:1, :SL])
    del params, long_toks
    torch.cuda.empty_cache()
    flash_backward = _flash_grads_check(q, k_, v, pos, pos, causal=True,
                                        window=W, q_block=cfg.attn_q_block,
                                        kv_block=cfg.attn_kv_block)
    del q, k_, v
    torch.cuda.empty_cache()

    decode_bound = (weight_bytes + cache_bytes) / roofline.HBM_BW
    decode_s = (gen_s - prefill_s) / (G - 1)
    return {
        "arch": SWA_ARCH, "params": n_params,
        "param_count_formula": cfg.param_count(), "weight_bytes": weight_bytes,
        "window": W, "batch": B, "prompt_len": S, "gen_len": G,
        "cache_len": cache_len, "ring_slots": ring_slots,
        "kv_cache_bytes": cache_bytes, "init_s": init_s,
        "consistency_rel_err": consistency,
        "prefill_median_s": prefill_s,
        "prefill_bound_s": _prefill_bound_s(cfg, B, S, cache_len),
        "generate_median_s": gen_s, "generate_runs_s": runs,
        "decode_s_per_step": decode_s,
        "decode_bound_s_per_step": decode_bound,
        "decode_busy_share": profile.get("device_busy_share"),
        "tokens_per_s": B * G / gen_s,
        "generate_calibrated_sync_median_s": gen_sync_s,
        "calibration_s_per_step_sync": (gen_sync_s - gen_s) / G,
        "observed_values": n, "q": SERVE_Q, "scale": float(want),
        "scale_fused_median_s": scale_s, "per_query": per_query,
        "phase_launches": launches,
        "sampled": {"seed": seed + 3, "generate_s": sampled_s,
                    "same_tokens_twice": True,
                    "tokens_unlike_greedy": int((sampled[0] != toks).sum()),
                    "host_sync": "none (set_sync_debug_mode error)"},
        "long_prompt": {
            **long_prompt, "cache_len": SL,
            "prefill_bound_s": _prefill_bound_s(cfg, B, SL, SL),
            "decode_s_per_step": long_decode_s,
            "decode_bound_s_per_step": decode_bound,
            "decode_tokens_per_s": B / long_decode_s},
        "flash_backward": flash_backward,
        "peak_memory_bytes": peak, "allocated_before_bytes": base,
        "profile_decode_step": profile,
        "wall_s": time.perf_counter() - t_phase,
    }, {"scale_fused": per_query}


# ---------------------------------------------------------------------------
# 11. the training path: stablelm-1.6b through train_loop
# ---------------------------------------------------------------------------


def _check_exact_quantile(what: str, grads, thr, q: float) -> None:
    """``thr`` is the exact q-quantile of |g| over every element of the
    gradient tree: count(|g| < thr) < k <= count(|g| <= thr), k =
    target_rank(n, q), with two direct counts summed in int64 (no code of
    the radix route)."""
    from repro_torch import pytree
    from repro_torch.core import local_ops
    leaves = pytree.leaves(grads)
    n = sum(g.numel() for g in leaves)
    k = local_ops.target_rank(n, q)
    lt = le = 0
    for g in leaves:
        a = g.float().abs()
        lt += int((a < thr).sum(dtype=torch.int64))
        le += int((a <= thr).sum(dtype=torch.int64))
    if not lt < k <= le:
        raise AssertionError(f"{what}: {float(thr)!r} is not the exact "
                             f"{q}-quantile of |g| over {n} values: "
                             f"{lt} below, {le} at or below, rank {k}")


class _OptimizerTaps:
    """Wraps ``quantile_clip_by_value`` and ``compress_int8`` where AdamW
    calls them: times each clip (synchronised), and checks each clip
    threshold and int8 scale with ``_check_exact_quantile`` and that no
    clipped |g| exceeds its threshold, timing the checks apart."""

    def __init__(self):
        from repro_torch.optim import adamw
        self.adamw = adamw
        self.clip_s, self.check_s, self.thresholds, self.scales = [], [], [], []

    def __enter__(self):
        from repro_torch import pytree
        clip, compress = (self.adamw.quantile_clip_by_value,
                          self.adamw.compress_int8)
        self.saved = clip, compress

        def tapped_clip(grads, q, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            clipped, thr = clip(grads, q, **kw)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            self.clip_s.append(t1 - t0)
            self.thresholds.append(float(thr))
            _check_exact_quantile("clip threshold", grads, thr, q)
            top = max(float(g.float().abs().max())
                      for g in pytree.leaves(clipped))
            if not top <= float(thr):
                raise AssertionError(f"clipped max |g| {top} > {float(thr)}")
            self.check_s.append(time.perf_counter() - t1)
            return clipped, thr

        def tapped_compress(grads, **kw):
            q8, scale = compress(grads, **kw)
            t0 = time.perf_counter()
            self.scales.append(float(scale))
            _check_exact_quantile("int8 scale", grads, scale,
                                  kw.get("q", 0.999))
            self.check_s.append(time.perf_counter() - t0)
            return q8, scale

        self.adamw.quantile_clip_by_value = tapped_clip
        self.adamw.compress_int8 = tapped_compress
        return self

    def __exit__(self, *exc):
        self.adamw.quantile_clip_by_value, self.adamw.compress_int8 = \
            self.saved
        return False


def _flash_grads_check(q, k, v, pos_q, pos_k, *, causal: bool,
                       window: int, q_block: int, kv_block: int) -> dict:
    """The blockwise attention's backward (``layers._flash``) on f32 q, k,
    v: dq, dk, dv of the autograd Function against autograd through the
    direct f32 formula, for a N(0, 1) cotangent, within 1e-4 of max
    |grad|; and the backward's peak memory above its operands beside one
    kv step's (B, NH, q_block, kv_block) scores."""
    from repro_torch.models import layers

    (B, Sq, NH, dh), Sk = q.shape, k.shape[1]
    if Sq * Sk <= q_block * kv_block * 2:
        raise AssertionError("flash check: not the blockwise path")
    gen = torch.Generator(device="cuda").manual_seed(7)
    dout = torch.randn(q.shape, generator=gen, device="cuda")

    def grads(**blocks):
        qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
        out = layers.attention(qq, kk, vv, pos_q, pos_k, causal=causal,
                               window=window, **blocks)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        out.backward(dout)
        torch.cuda.synchronize()
        return ((qq.grad, kk.grad, vv.grad),
                torch.cuda.max_memory_allocated() - before,
                time.perf_counter() - t0)

    blockwise, peak, flash_s = grads(q_block=q_block, kv_block=kv_block)
    direct, direct_peak, direct_s = grads(q_block=Sq, kv_block=Sk)
    err = max(float((a - b).abs().max() / b.abs().max())
              for a, b in zip(blockwise, direct))
    if not err <= 1e-4:
        raise AssertionError(f"flash backward (causal={causal}, Sq={Sq}, "
                             f"Sk={Sk}): {err} of max |grad| off the "
                             f"direct formula")
    return {"batch": B, "seq_len": Sq, "keys": Sk, "heads": NH,
            "d_head": dh, "causal": causal, "padded_keys": -Sk % kv_block,
            "rel_err": err, "bound": 1e-4,
            "backward_peak_above_operands_bytes": peak,
            "kv_step_scores_bytes": B * NH * q_block * kv_block * 4,
            "backward_s": flash_s,
            "direct_backward_peak_above_operands_bytes": direct_peak,
            "direct_backward_s": direct_s}


@torch.no_grad()
def _first_layer_qkv(params, cfg, tokens: torch.Tensor) -> tuple:
    """The first layer's rotated q and k and its v for ``tokens`` (B, S),
    each (B, S, heads, dh) in f32, and the positions."""
    from repro_torch.models import layers, model

    B, S = tokens.shape
    NH, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    x, pos, _ = model._embed_inputs(params.p, {"tokens": tokens}, cfg)
    p = params.blocks[0].p
    h = layers.norm(x, p, cfg, "ln1")
    q, k = (layers.apply_rope((h @ p[w]).reshape(B, S, n, dh), pos,
                              cfg.rope_theta).float()
            for w, n in (("wq", NH), ("wk", KV)))
    v = (h @ p["wv"]).reshape(B, S, KV, dh).float()
    return q, k, v, pos


def _flash_backward_check(params, cfg, batch) -> dict:
    """``_flash_grads_check`` at full width on the first layer's q, k, v
    (in f32) for the training batch (causal)."""
    q, k, v, pos = _first_layer_qkv(params, cfg, batch["tokens"])
    return _flash_grads_check(q, k, v, pos, pos, causal=True,
                              window=cfg.swa_window,
                              q_block=cfg.attn_q_block,
                              kv_block=cfg.attn_kv_block)


def _exact_resume(cfg, seed: int) -> dict:
    """TRAIN_RESUME_LAYERS layers at full width: TRAIN_STEPS steps
    uninterrupted against half of them, a checkpoint through a temporary
    directory and a restart for the rest.  The restored params, m and v
    equal the saved ones bit for bit; the losses agree within the
    reference's resume bound (rtol = atol = 2e-4)."""
    import tempfile
    from repro_torch import pytree
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.launch.train import _state_tree, train_loop
    from repro_torch.models import model

    cfg = dataclasses.replace(cfg, n_layers=TRAIN_RESUME_LAYERS)
    run = dict(global_batch=TRAIN_B, seq_len=TRAIN_S, seed=seed,
               log_every=0, device="cuda")
    half = TRAIN_STEPS // 2
    full = train_loop(cfg, steps=TRAIN_STEPS, **run)["losses"]
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d:
        partial, save_s = _sync_time(lambda: train_loop(
            cfg, steps=half, ckpt_dir=d, ckpt_every=100, **run))
        tree = _state_tree(model.param_tree(partial["params"]),
                           partial["opt_state"], "cuda")
        ckpt_bytes = sum(t.numel() * t.element_size()
                         for t in pytree.leaves(tree))
        (restored, _), restore_s = _sync_time(
            lambda: restore_checkpoint(d, tree, device="cuda"))
        same = all(torch.equal(_bits(a), _bits(b)) for a, b in
                   zip(pytree.leaves(restored), pytree.leaves(tree)))
        if not same:
            raise AssertionError("train resume: the restored state differs "
                                 "from the saved one")
        del tree, restored, partial["params"], partial["opt_state"]
        torch.cuda.empty_cache()
        resumed = train_loop(cfg, steps=TRAIN_STEPS, ckpt_dir=d,
                             ckpt_every=100, **run)["losses"]
    got = partial["losses"] + resumed
    diff = [abs(a - b) for a, b in zip(got, full)]
    ok = len(got) == len(full) and all(
        dd <= 2e-4 + 2e-4 * abs(b) for dd, b in zip(diff, full))
    if not ok:
        raise AssertionError(f"train resume: losses {got} against {full}")
    return {"layers": cfg.n_layers, "steps": TRAIN_STEPS, "restart_at": half,
            "losses_uninterrupted": full, "losses_resumed": got,
            "max_abs_diff": max(diff), "bound": "rtol = atol = 2e-4",
            "checkpoint_bytes": ckpt_bytes,
            "partial_run_with_save_s": save_s, "restore_s": restore_s,
            "state_bit_exact": same}


def train_path(seed: int) -> dict:
    """stablelm-1.6b at its published width and depth (1.64 B bf16
    parameters from ``--seed``) through ``train_loop``: TRAIN_STEPS steps
    of TRAIN_B x TRAIN_S Zipf tokens, AdamW with the exact 0.999-quantile
    clip, ``remat="nothing_saveable"``; then one step with int8
    compression.  Every loss is finite, and every clip threshold and the
    int8 scale of these steps is the exact quantile of what it was taken
    over.  Then one more step, profiled (without those checks), the flash
    backward at full width and exact resume at
    TRAIN_RESUME_LAYERS layers."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch import roofline
    from repro_torch.launch.train import train_loop
    from repro_torch.optim import AdamWConfig

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(TRAIN_ARCH)
    if cfg.remat != "nothing_saveable":
        raise AssertionError(f"train: remat {cfg.remat!r}")
    with _OptimizerTaps() as taps:
        out = train_loop(cfg, steps=TRAIN_STEPS, global_batch=TRAIN_B,
                         seq_len=TRAIN_S, seed=seed, log_every=1,
                         device="cuda")
        if len(out["losses"]) != TRAIN_STEPS or not all(
                math.isfinite(l) for l in out["losses"]):
            raise AssertionError(f"train: losses {out['losses']}")
        if len(taps.thresholds) != TRAIN_STEPS:
            raise AssertionError(f"train: {len(taps.thresholds)} clips in "
                                 f"{TRAIN_STEPS} steps")
        peak = torch.cuda.max_memory_allocated() - base
        params, opt_state = out["params"], out["opt_state"]
        batch = _train_batch(cfg, TRAIN_STEPS, seed)
        compress_step = make_train_step(cfg, AdamWConfig(
            quantile_clip=TRAIN_Q, compress_bits=8))
        torch.cuda.reset_peak_memory_stats()
        (_, opt_state, m), compress_s = _sync_time(
            lambda: compress_step(params, opt_state, batch))
        compress = {"loss": float(m["loss"]),
                    "scale": float(m["compress_scale"]),
                    "clip_threshold": float(m["clip_threshold"]),
                    "step_s": compress_s,
                    "peak_memory_bytes":
                    torch.cuda.max_memory_allocated() - base}
        if not (math.isfinite(compress["loss"]) and len(taps.scales) == 1):
            raise AssertionError(f"train compress step: {compress}")
    # one more step, profiled, without the taps' checks and syncs
    step = make_train_step(cfg, AdamWConfig(quantile_clip=TRAIN_Q))
    profiled = _profile(lambda: step(params, opt_state, batch), warm=False)
    checks = {"clip_thresholds": taps.thresholds, "int8_scales": taps.scales,
              "check_s": taps.check_s}
    del opt_state, m, step
    torch.cuda.empty_cache()
    flash = _flash_backward_check(params, cfg, batch)
    n_params = sum(w.numel() for w in params.parameters())
    del params, out["params"], out["opt_state"]
    torch.cuda.empty_cache()
    resume = _exact_resume(cfg, seed)

    # steps 2..TRAIN_STEPS, each without its exactness checks
    timed = [s - c for s, c in zip(out["step_s"], taps.check_s)][1:]
    step_s = statistics.median(timed)
    clip_s = statistics.median(taps.clip_s[1:TRAIN_STEPS])
    tokens = TRAIN_B * TRAIN_S
    return {
        "arch": TRAIN_ARCH, "params": n_params, "layers": cfg.n_layers,
        "batch": TRAIN_B, "seq_len": TRAIN_S, "tokens_per_step": tokens,
        "remat": cfg.remat, "quantile_clip": TRAIN_Q,
        "losses": out["losses"], "step_s_each": out["step_s"],
        "step_s": step_s, "tokens_per_s": tokens / step_s,
        "model_flops_share": 6 * n_params * tokens / step_s
        / roofline.PEAK_FLOPS,
        "model_flops_bound_s": 6 * n_params * tokens / roofline.PEAK_FLOPS,
        "clip_s": clip_s, "clip_share_of_step": clip_s / step_s,
        "clip_s_each": taps.clip_s, "peak_memory_bytes": peak,
        "exactness": checks, "compress_step": compress,
        "profiled_step": profiled, "flash_backward": flash,
        "exact_resume": resume, "wall_s": time.perf_counter() - t_phase,
    }


# ---------------------------------------------------------------------------
# 11b. the vlm, audio, ssm, hybrid and moe families through train_loop
# ---------------------------------------------------------------------------


def _train_batch(cfg, step: int, seed: int) -> dict:
    """``train_loop``'s batch of ``step`` on the card: TRAIN_B x TRAIN_S
    Zipf tokens and the family's patches or frames, from ``--seed``."""
    from repro_torch.data import DataConfig, SyntheticPipeline
    pipe = SyntheticPipeline(DataConfig(
        vocab=cfg.vocab, seq_len=TRAIN_S, global_batch=TRAIN_B, seed=seed,
        frontend_len=cfg.frontend_len,
        enc_seq=TRAIN_S // cfg.enc_seq_divisor if cfg.is_encdec else 0,
        d_model=cfg.d_model))
    return {k: torch.as_tensor(v, device="cuda")
            for k, v in pipe.batch_at(step).items()}


@contextlib.contextmanager
def _full_f32():
    """While open, f32 matmuls and cuDNN's convolutions run in full f32
    (no TF32), forward and backward."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _loss_grads(params, cfg, batch) -> tuple:
    """(loss, every gradient in ``param_tree`` order) of one forward and
    backward of ``forward_loss``."""
    from repro_torch import pytree
    from repro_torch.models import model
    tree = pytree.leaves(model.param_tree(params))
    params.requires_grad_(True)
    loss, _ = model.forward_loss(params, batch, cfg)
    loss.backward()
    grads = [w.grad for w in tree]
    for w in tree:
        w.grad = None
    params.requires_grad_(False)
    return float(loss.detach()), grads


class _RouteTap:
    """Wraps ``repro_torch.models.moe.route`` while active: each call's
    experts (T, k), sorted along k, are appended to ``calls`` (a
    rematerialised layer's route runs again in the backward)."""

    def __init__(self):
        from repro_torch.models import moe
        self.moe, self.calls = moe, []

    def __enter__(self):
        route = self.route = self.moe.route

        def tapped(p, xt, cfg):
            out = route(p, xt, cfg)
            self.calls.append(out[2].sort(-1).values)
            return out
        self.moe.route = tapped
        return self

    def __exit__(self, *exc):
        self.moe.route = self.route
        return False


# the moe leaves that the gradient gate prints and does not hold (a
# flipped expert choice is a discrete change, in both packages), as the
# reference's layout names them; all but the router are the experts'
_ROUTED = ("['blocks']['router']", "['blocks']['we_gate']",
           "['blocks']['we_up']", "['blocks']['we_down']")


def _stacked_leaf_of(tree) -> list:
    """For each leaf of ``tree`` (a ``param_tree``), the path of the leaf
    of the reference's layout that stacks it."""
    from repro_torch import pytree
    from repro_torch.models import model
    out = [None] * len(pytree.leaves(tree))
    for path, idx in model.by_stacked_leaf(tree, range(len(out))).items():
        for i in idx:
            out[int(i)] = path
    return out


def _grad_vs_f32(params, cfg, batch) -> dict:
    """One step's gradients of ``batch`` (GRAD_B rows) in bf16, twice
    (``same_bits_twice``: the same loss and gradient bits both times), and
    for ``param_dtype="float32"`` on the same weights cast to f32, with
    TF32 off.  Gate: every leaf of the port's tree (one layer's weight)
    within GRAD_TOL (or twice its reading in GRAD_GAP_CPU) of its f32
    evaluation: max |g_bf16 - g_f32| over max |g_f32|.  Printed
    beside it, grouped by the leaf of the reference's layout that stacks
    them: each group's worst layer, and the group taken whole (its
    layers' max |g_bf16 - g_f32| over their max |g_f32|).  A moe model's
    router and expert leaves are printed, not held, beside the (token,
    layer) expert choices on which the two evaluations differ (in their
    forwards)."""
    from repro_torch import pytree
    from repro_torch.models import model

    tree = model.param_tree(params)
    names = pytree.paths(tree)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    with _RouteTap() as tap:
        loss, grads = _loss_grads(params, cfg, batch)
        routes, tap.calls = tap.calls[:cfg.n_layers], []
        loss2, grads2 = _loss_grads(params, cfg, batch)
        same = loss == loss2 and _same_bits(grads, grads2)
        del grads2
        f32 = dataclasses.replace(cfg, param_dtype="float32")
        params32 = model.Transformer(f32, device="cuda")
        with torch.no_grad():
            for dst, src in zip(pytree.leaves(model.param_tree(params32)),
                                pytree.leaves(tree)):
                dst.copy_(src)
        tap.calls = []
        with _full_f32():
            loss32, grads32 = _loss_grads(params32, f32, batch)
        routes32 = tap.calls[:cfg.n_layers]
    del params32
    diff = [float((g.float() - w).abs().max())
            for g, w in zip(grads, grads32)]
    scale = [float(w.abs().max()) for w in grads32]
    del grads, grads32
    gaps = [d / max(w, 1e-30) for d, w in zip(diff, scale)]
    limits = {k: 2 * max(v)
              for k, v in GRAD_GAP_CPU.get(cfg.name, {}).items()}
    of = _stacked_leaf_of(tree)
    routed = {n for n, k in zip(names, of)
              if cfg.family == "moe" and k in _ROUTED}
    tol = {n: limits.get(k, GRAD_TOL) for n, k in zip(names, of)}
    gated = {n: g for n, g in zip(names, gaps) if n not in routed}
    worst = max(gated, key=gated.get)
    d, w, g = (model.by_stacked_leaf(tree, v) for v in (diff, scale, gaps))

    def ranked(kv: dict) -> dict:
        return dict(sorted(kv.items(), key=lambda kv: -kv[1]))

    out = {"batch": list(batch["tokens"].shape), "loss_bf16": loss,
           "loss_f32": loss32, "leaves": len(names),
           "gated_leaves": len(gated), "tolerance": GRAD_TOL,
           "tolerance_by_stacked_leaf": limits,
           "worst_leaf": worst, "worst_share_of_max": gated[worst],
           "per_stacked_leaf_worst_layer": ranked(
               {k: max(v) for k, v in g.items()}),
           "stacked_share_of_max": ranked(
               {k: max(d[k]) / max(max(w[k]), 1e-30) for k in d}),
           "over_tolerance": {n: x for n, x in gated.items()
                              if not x <= tol[n]},
           "same_bits_twice": same,
           "peak_above_before_bytes": torch.cuda.max_memory_allocated()
           - base, "seconds": time.perf_counter() - t0}
    if routed:
        out["routed_leaves"] = len(routed)
        out["token_layer_choices"] = sum(r.shape[0] for r in routes)
        out["token_layer_choices_differ"] = int(sum(
            (a != b).any(-1).sum() for a, b in zip(routes, routes32)))
    if not (math.isfinite(loss) and math.isfinite(loss32)):
        raise AssertionError(f"{cfg.name}: gradient gate losses {out}")
    if out["over_tolerance"]:
        raise AssertionError(f"{cfg.name}: bf16 gradients off their f32 "
                             f"evaluation: {out}")
    return out


@torch.no_grad()
def _moe_layer_input(params, batch, cfg) -> torch.Tensor:
    """The first layer's ``moe_block`` input (B, S, D) for ``batch``."""
    from repro_torch.models import layers, model
    p = params.blocks[0].p
    x, pos, pos3 = model._embed_inputs(params.p, batch, cfg)
    h, _ = layers.attn_block(p, layers.norm(x, p, cfg, "ln1"), cfg,
                             positions=pos, positions3=pos3)
    return layers.norm(x + h, p, cfg, "ln2")


def _moe_backward(params, batch, cfg) -> dict:
    """The first layer's ``moe_block`` at full width on the training
    batch's tokens, dropless (capacity factor E / k: every assignment
    kept), for a N(0, 1) cotangent of its output: autograd through the
    block against autograd through the direct formula in f32 (TF32 off)
    on the same routing: every expert on every token (MOE_FORMULA_EXPERTS
    experts at a time), each token's experts by their gates (the router's
    softmax in f32, renormalised over the token's k experts, so that dx
    takes the gates' path too), summed.  dx and each expert weight's
    gradient within MOE_GRAD_TOL of its max |grad|."""
    import torch.nn.functional as F
    from repro_torch.models import moe

    E, k = cfg.moe_experts, cfg.moe_top_k
    dropless = dataclasses.replace(cfg, moe_capacity_factor=E / k)
    p = dict(params.blocks[0].p.items())
    xn = _moe_layer_input(params, batch, cfg)
    B, S, D = xn.shape
    T = B * S
    names = ("we_gate", "we_up", "we_down")
    gen = torch.Generator(device="cuda").manual_seed(11)
    dy = torch.randn((B, S, D), generator=gen, device="cuda").to(xn.dtype)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x = xn.detach().requires_grad_()
    w = {n: p[n].detach().requires_grad_() for n in names}
    y, _ = moe.moe_block({**p, **w}, x, dropless)
    y.backward(dy)
    got = [x.grad] + [w[n].grad for n in names]
    torch.cuda.synchronize()
    block_s = time.perf_counter() - t0
    del x, w, y
    with torch.no_grad():
        _, _, top_i = moe.route(p, xn.reshape(T, D), cfg)
        load = torch.bincount(top_i.reshape(-1), minlength=E)
    cap = moe.capacity(T, dropless)
    if int(load.max()) > cap:
        raise AssertionError(f"moe backward: capacity {cap} drops")

    t0 = time.perf_counter()
    with _full_f32():
        x = xn.detach().float().requires_grad_()
        w = {n: p[n].detach().float().requires_grad_() for n in names}
        xt = x.reshape(T, D)
        probs = torch.softmax(xt @ p["router"].float(), -1)
        gates = probs.gather(1, top_i)
        gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
        g_leaf = gates.detach().requires_grad_()
        dy32 = dy.reshape(T, D).float()
        tok = torch.arange(T, device="cuda")[:, None]
        n = MOE_FORMULA_EXPERTS
        for e0 in range(0, E, n):
            es = slice(e0, e0 + n)
            hid = F.silu(xt @ w["we_gate"][es]) * (xt @ w["we_up"][es])
            out = hid @ w["we_down"][es]                     # (n, T, D)
            mine = (top_i >= e0) & (top_i < e0 + n)
            picked = out[(top_i - e0).clamp(0, n - 1), tok]  # (T, k, D)
            y_c = (picked * torch.where(mine, g_leaf, 0.0)[..., None]).sum(1)
            (y_c * dy32).sum().backward()
            del hid, out, picked, y_c
        gates.backward(g_leaf.grad)
        want = [x.grad] + [w[n].grad for n in names]
    torch.cuda.synchronize()
    formula_s = time.perf_counter() - t0
    errs = {name: _rel_err(a.float(), b) for name, a, b
            in zip(("dx",) + names, got, want)}
    del got, want, x, w
    torch.cuda.empty_cache()
    out = {"tokens": T, "capacity": cap, "max_expert_load": int(load.max()),
           "rel_err": errs, "tolerance": MOE_GRAD_TOL, "block_s": block_s,
           "formula_s": formula_s,
           "formula_flop": 3 * 2 * 3 * E * T * D * cfg.d_ff}
    if not all(e <= MOE_GRAD_TOL for e in errs.values()):
        raise AssertionError(f"moe backward off its f32 formula: {out}")
    return out


def _cross_flash_check(cfg, seed: int) -> dict:
    """``_flash_grads_check`` at an encoder-decoder's cross-attention shape
    (CROSS_FLASH: B, heads, d_head, Sq, Sk frames), non-causal, on N(0, 1)
    f32 q, k, v from ``--seed``: Sk is not a multiple of ``kv_block``, so
    the padded keys' mask runs in the backward."""
    B, NH, dh, Sq, Sk = CROSS_FLASH
    if Sk % cfg.attn_kv_block == 0:
        raise AssertionError("cross flash check: no padded keys")
    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    q, k, v = (torch.randn((B, n, NH, dh), generator=gen, device="cuda")
               for n in (Sq, Sk, Sk))

    def pos(n):
        return torch.arange(n, dtype=torch.int32,
                            device="cuda").expand(B, n)
    return _flash_grads_check(q, k, v, pos(Sq), pos(Sk), causal=False,
                              window=0, q_block=cfg.attn_q_block,
                              kv_block=cfg.attn_kv_block)


def family_train_path(name: str, arch: str, seed: int) -> dict:
    """``arch`` (the vlm, audio, ssm, hybrid or moe family) at its published
    width, and at its published depth but for olmoe-1b-7b's
    MOE_TRAIN_LAYERS (its 16 layers' state does not fit one card),
    first at the weights ``train_loop`` starts from, the bf16 gradients of
    the first GRAD_B rows of its first batch against an f32 evaluation
    (``_grad_vs_f32``); then through ``train_loop`` from ``--seed``:
    FAMILY_TRAIN_STEPS steps of TRAIN_B x TRAIN_S Zipf tokens with the
    pipeline's patches or frames, AdamW with the exact TRAIN_Q clip and
    the config's remat.  Every loss is finite and every clip threshold the
    exact quantile of its |g| (``_OptimizerTaps``); then one more step,
    profiled, without those checks.  With the optimizer state freed: a
    moe model's first ``moe_block`` backward against its f32 formula
    (``_moe_backward``); an encoder-decoder's cross-attention backward at
    CROSS_FLASH.  Every launch count is zeroed at the start and must be 0
    at the end: the training path launches none of the kernels."""
    import repro_torch.kernels as K
    from repro_torch import pytree
    from repro_torch.configs import get_config
    from repro_torch.launch import roofline
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import train_loop
    from repro_torch.models import model
    from repro_torch.optim import AdamWConfig

    t_phase = time.perf_counter()
    K.reset_launches()
    cfg = get_config(arch)
    published = cfg.n_layers + cfg.enc_layers
    reduced = None
    if cfg.family == "moe":
        cfg = dataclasses.replace(cfg, n_layers=MOE_TRAIN_LAYERS)
        reduced = {"n_layers": f"{MOE_TRAIN_LAYERS} of {published}: the "
                   f"deepest whose run peaks under 72 GB on one card (about "
                   f"6.7 GB a layer; the published depth's weights, "
                   f"gradients and AdamW state alone are 83 GB)"}
    # the gradient gate at the weights train_loop starts from, on the
    # first rows of its first batch
    params = model.init_params(cfg, seed, device="cuda")
    grad_gate = _grad_vs_f32(params, cfg, {
        k: v[:GRAD_B] for k, v in _train_batch(cfg, 0, seed).items()})
    del params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with _OptimizerTaps() as taps:
        out = train_loop(cfg, steps=FAMILY_TRAIN_STEPS, global_batch=TRAIN_B,
                         seq_len=TRAIN_S, seed=seed, log_every=1,
                         device="cuda")
    losses = out["losses"]
    if len(losses) != FAMILY_TRAIN_STEPS or not all(
            math.isfinite(l) for l in losses):
        raise AssertionError(f"{name}: losses {losses}")
    if len(taps.thresholds) != FAMILY_TRAIN_STEPS:
        raise AssertionError(f"{name}: {len(taps.thresholds)} clips in "
                             f"{FAMILY_TRAIN_STEPS} steps")
    params, opt_state = out.pop("params"), out.pop("opt_state")
    batch = _train_batch(cfg, FAMILY_TRAIN_STEPS, seed)
    step = make_train_step(cfg, AdamWConfig(quantile_clip=TRAIN_Q))
    profiled = _profile(lambda: step(params, opt_state, batch), warm=False)
    peak = torch.cuda.max_memory_allocated() - base
    tree = model.param_tree(params)
    n_params = sum(w.numel() for w in pytree.leaves(tree))
    # the experts' weights, of which a token runs k of E
    n_experts = sum(w.numel() for w, k in zip(pytree.leaves(tree),
                                              _stacked_leaf_of(tree))
                    if k in _ROUTED[1:])
    n_leaves = len(pytree.leaves(tree))
    del opt_state, step, tree
    torch.cuda.empty_cache()

    moe_bwd = (_moe_backward(params, batch, cfg)
               if cfg.family == "moe" else None)
    del params, batch
    torch.cuda.empty_cache()
    cross = _cross_flash_check(cfg, seed) if cfg.is_encdec else None
    if any(K.launches().values()):
        raise AssertionError(f"{name} launched {K.launches()}")
    if not peak < roofline.HBM_BYTES:
        raise AssertionError(f"{name}: peak {peak} bytes")

    # steps 2.., each without its exactness checks
    timed = [s - c for s, c in zip(out["step_s"], taps.check_s)][1:]
    step_s = statistics.median(timed)
    clip_s = statistics.median(taps.clip_s[1:])
    tokens = TRAIN_B * TRAIN_S
    bound_s = roofline.model_flops(cfg, tokens, "train") / roofline.PEAK_FLOPS
    active = n_params - n_experts * (cfg.moe_experts - cfg.moe_top_k) \
        // cfg.moe_experts if cfg.family == "moe" else n_params
    tensor_bound_s = 6 * active * tokens / roofline.PEAK_FLOPS
    return {
        "arch": arch, "family": cfg.family, "params": n_params,
        "param_count_formula": cfg.param_count(),
        "active_params_per_token": active,
        "active_param_count_formula": cfg.active_param_count(),
        "layers": cfg.n_layers + cfg.enc_layers,
        "layers_published": published, "reduced": reduced,
        "remat": cfg.remat, "batch": TRAIN_B, "seq_len": TRAIN_S,
        "tokens_per_step": tokens, "patch_positions": cfg.frontend_len,
        "frames": TRAIN_S // cfg.enc_seq_divisor if cfg.is_encdec else 0,
        "quantile_clip": TRAIN_Q, "losses": losses,
        "step_s_each": out["step_s"], "step_s": step_s,
        "tokens_per_s": tokens / step_s,
        "model_flops_bound_s": bound_s,
        "model_flops_share": bound_s / step_s,
        "model_flops_bound_s_from_tensors": tensor_bound_s,
        "model_flops_share_from_tensors": tensor_bound_s / step_s,
        "clip_s": clip_s, "clip_share_of_step": clip_s / step_s,
        "clip_s_each": taps.clip_s, "clip_leaves": n_leaves,
        "clip_thresholds": taps.thresholds, "check_s": taps.check_s,
        "peak_memory_bytes": peak, "profiled_step": profiled,
        "moe_backward": moe_bwd, "grad_vs_f32": grad_gate,
        "same_bits_twice": grad_gate["same_bits_twice"],
        "cross_flash_backward": cross,
        "wall_s": time.perf_counter() - t_phase,
    }


# ---------------------------------------------------------------------------
# 12. the dry-run tooling, and a sharded step on the card
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _dryrun_cells():
    """(a): the dry-run CLI on DRYRUN_CELLS, started on entry (one
    subprocess, which traces each cell in a process of its own, all at
    once, on the host's other cores) and read on exit into the yielded
    dict: each record's per-chip figures.  A cell fails unless ``ok`` and
    within the card's memory."""
    result = {}
    with tempfile.TemporaryDirectory() as out, \
            tempfile.TemporaryFile("w+") as log:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--out",
               out, "--force", "--jobs", str(len(DRYRUN_CELLS))]
        for cell in DRYRUN_CELLS:
            cmd += ["--cell", ":".join(cell)]
        env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
        t0 = time.perf_counter()
        # a session of its own, so that the cells' processes stop with it
        proc = subprocess.Popen(cmd, env=env, stdout=log,
                                stderr=subprocess.STDOUT,
                                start_new_session=True)
        try:
            yield result
            proc.wait(timeout=max(1.0, DRYRUN_LIMIT_S
                                  - (time.perf_counter() - t0)))
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
        wall = time.perf_counter() - t0
        log.seek(0)
        output = log.read()
        records = {}
        for arch, shape, mesh in DRYRUN_CELLS:
            path = os.path.join(out, f"{arch}__{shape}__{mesh}.json")
            rec = json.load(open(path)) if os.path.exists(path) else {
                "status": "missing"}
            records[f"{arch}:{shape}:{mesh}"] = {
                k: rec.get(k) for k in (
                    "status", "error", "kind", "chips", "trace_s",
                    "hlo_flops_per_chip", "hlo_bytes_per_chip",
                    "collective_bytes_per_chip", "collective_counts",
                    "collective_breakdown", "collective_result_breakdown",
                    "model_flops_per_chip", "useful_flops_ratio",
                    "memory_analysis")}
            records[f"{arch}:{shape}:{mesh}"]["dominant"] = (
                rec.get("roofline") or {}).get("dominant")
    bad = [c for c, r in records.items() if r["status"] != "ok"
           or r["memory_analysis"]["exceeds_card_memory"]]
    if proc.returncode != 0 or bad:
        raise AssertionError(f"dryrun: exit {proc.returncode}, cells {bad}: "
                             f"{output[-4000:]}")
    result.update(cells=records, subprocess_s=wall,
                  trace_s=sum(r["trace_s"] for r in records.values()))


def _grad_gaps(got, want, names) -> dict:
    """{leaf path: max |got - want| / max |want|}."""
    return {n: float((g.float() - w.float()).abs().max())
            / max(float(w.float().abs().max()), 1e-30)
            for n, g, w in zip(names, got, want)}


@contextlib.contextmanager
def _embedding_output_grads(model, store: list):
    """While open, the gradient that reaches the embedding's output (dL/dx,
    (B, S, D)) of every ``model._embed`` call is appended to ``store`` as
    a plain tensor."""
    from repro_torch.models import layers
    embed = model._embed

    def hooked(table, tokens):
        x = embed(table, tokens)
        if x.requires_grad:
            x.register_hook(lambda g: store.append(layers.whole(g)))
        return x
    model._embed = hooked
    try:
        yield store
    finally:
        model._embed = embed


def _f32_embed_grad(tokens: torch.Tensor, dx: torch.Tensor,
                    vocab: int) -> torch.Tensor:
    """The embedding table's gradient summed in f32: each position's dL/dx
    (in f32) added into its token's row (``index_add_``), no rounding to
    the table's dtype.  The witness both training steps' embedding
    gradients are held to."""
    D = dx.shape[-1]
    return torch.zeros((vocab, D), dtype=torch.float32,
                       device=dx.device).index_add_(
        0, tokens.reshape(-1).long(), dx.reshape(-1, D).float())


def _train_grads(params, cfg, batch, mesh):
    """(loss, the gradients as plain tensors, the exact TRAIN_Q-quantile
    of |g| by the radix route, the embedding output's gradient dL/dx) of
    one forward and backward, plain or on ``mesh``."""
    from repro_torch import pytree
    from repro_torch.launch import steps
    from repro_torch.models import layers, model
    from repro_torch.optim.quantile_ops import pytree_radix_quantile
    tree = model.param_tree(params)
    params.requires_grad_(True)
    with steps.on_mesh(mesh), _embedding_output_grads(model, []) as dx:
        loss, _ = model.forward_loss(params, batch, cfg)
        loss.backward()
        grads = [steps.placed_grad(p) for p in pytree.leaves(tree)]
        for p in pytree.leaves(tree):
            p.grad = None
        params.requires_grad_(False)
        thr = pytree_radix_quantile(grads, TRAIN_Q)
    local = [g.to_local() if hasattr(g, "to_local") else g for g in grads]
    (dx,) = dx
    return float(layers.whole(loss).detach()), local, thr, dx


def _second_s(fn) -> tuple:
    """(result, seconds) of the second of two runs."""
    _sync_time(fn)
    return _sync_time(fn)


# the sharded steps' gates on bf16 weights: ``test_torch_train.py``'s bf16
# tolerances (loss 1e-4, each gradient 3e-2 of its leaf's max |g|, the
# embedding's also against its f32 sum), the logits 1e-3 of max |logit|
# (about a bf16 half-ulp)
SHARDED_LOSS_TOL, SHARDED_GRAD_TOL, SHARDED_LOGIT_TOL = 1e-4, 3e-2, 1e-3


def _sharded_train(mesh, seed: int, arch: str, n_layers=None) -> dict:
    """One of SHARDED_TRAIN: ``arch`` (at ``n_layers`` where given) at
    TRAIN_B x TRAIN_S, its sharded train step held to the plain one."""
    from repro_torch import pytree
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as shd, steps
    from repro_torch.models import layers, model
    from repro_torch.optim import AdamWConfig, adamw_init

    cfg = get_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    params = model.init_params(cfg, seed, device="cuda")
    batch = _train_batch(cfg, 0, seed)
    opt_cfg = AdamWConfig(quantile_clip=TRAIN_Q)
    loss_p, grads_p, thr_p, dx_p = _train_grads(params, cfg, batch, None)
    names = pytree.paths(model.param_tree(params))
    at = names.index("['embed']")
    # the embedding's gradient against its f32 sum; and what the index's
    # backward (``table[tokens]``: ``index_put_`` with accumulate, in the
    # table's dtype) makes of the same dL/dx
    witness_p = _f32_embed_grad(batch["tokens"], dx_p, cfg.vocab)
    embed_f32_gap_p = _rel_err(grads_p[at].float(), witness_p)
    index_put = torch.zeros_like(grads_p[at]).index_put_(
        (batch["tokens"].reshape(-1).long(),),
        dx_p.reshape(-1, dx_p.shape[-1]), accumulate=True)
    index_put_f32_gap = _rel_err(index_put.float(), witness_p)
    del dx_p, witness_p, index_put
    tree = model.param_tree(params)
    saved = [w.detach().clone() for w in pytree.leaves(tree)]
    step = steps.make_train_step(cfg, opt_cfg)
    opt = adamw_init(tree)
    _, plain_s = _second_s(lambda: step(params, opt, batch))
    del opt, step
    with torch.no_grad():
        for w, v in zip(pytree.leaves(tree), saved):
            w.copy_(v)
    del saved
    torch.cuda.empty_cache()

    mcfg = steps.mesh_cfg(cfg, mesh, TRAIN_B)
    shd.distribute_params(params, mesh)
    batch = steps.distribute_inputs((batch,), (shd.placements_tree(
        mesh, shd.batch_spec(mesh, batch, TRAIN_B)),), mesh)[0]
    loss_s, grads_s, thr_s, dx_s = _train_grads(params, mcfg, batch, mesh)
    _check_exact_quantile(f"{arch} sharded train step", grads_s, thr_s,
                          TRAIN_Q)
    # the embedding's gradient sums every occurrence of a token (Zipf:
    # thousands for the common ones): both steps' are held to its f32 sum
    embed_f32_gap_s = _rel_err(grads_s[at].float(), _f32_embed_grad(
        layers.whole(batch["tokens"]), dx_s, cfg.vocab))
    del dx_s
    gaps = _grad_gaps(grads_s, grads_p, names)
    worst = max(gaps, key=gaps.get)
    gap = gaps[worst]
    same = all(torch.equal(a, b) for a, b in zip(grads_s, grads_p))
    del grads_p, grads_s
    tree = model.param_tree(params)
    opt = adamw_init(tree)
    opt = steps.distribute_inputs((opt,), (shd.placements_tree(
        mesh, shd.opt_shardings(mesh, opt, tree)),), mesh)[0]
    step = steps.make_train_step(mcfg, opt_cfg, mesh)
    _, sharded_s = _second_s(lambda: step(params, opt, batch))
    out = {"arch": arch, "layers": cfg.n_layers, "batch": TRAIN_B,
           "seq_len": TRAIN_S, "loss_plain": loss_p, "loss_sharded": loss_s,
           "loss_bits_equal": loss_p == loss_s,
           "loss_gap": abs(loss_s - loss_p), "grads_bits_equal": same,
           "grad_gap_share_of_max": gap, "grad_gap_worst_leaf": worst,
           "leaves_bits_equal": sum(g == 0.0 for g in gaps.values()),
           "leaves": len(gaps),
           "embed_grad_gap_share_of_max": gaps["['embed']"],
           "embed_grad_f32_gap_plain": embed_f32_gap_p,
           "embed_grad_f32_gap_sharded": embed_f32_gap_s,
           "index_put_f32_gap": index_put_f32_gap,
           "clip_threshold_plain": float(thr_p),
           "clip_threshold_sharded": float(thr_s),
           "step_s_plain": plain_s, "step_s_sharded": sharded_s}
    if not (math.isfinite(loss_s) and out["loss_gap"] <= SHARDED_LOSS_TOL
            and gap <= SHARDED_GRAD_TOL
            and embed_f32_gap_p <= SHARDED_GRAD_TOL
            and embed_f32_gap_s <= SHARDED_GRAD_TOL):
        raise AssertionError(f"{arch} sharded train step: {out}")
    return out


def _sharded_serve(mesh, seed: int) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as shd, steps
    from repro_torch.models import layers, model

    cfg = get_config(SERVE_ARCH)
    B, S = SERVE_B, SERVE_PROMPT
    params = model.init_params(cfg, seed, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    tokens = torch.randint(0, cfg.vocab, (B, S + 1), generator=gen,
                           device="cuda", dtype=torch.int32)
    inputs = ({"tokens": tokens[:, :S]}, tokens[:, S:],
              torch.full((B,), S, dtype=torch.int32, device="cuda"))

    def run(cfg, mesh, inputs, recache):
        prompt, token, at = inputs
        prefill = steps.make_prefill_step(cfg, S + 1, mesh)
        decode = steps.make_decode_step(cfg, mesh)
        (logits, cache), pre_s = _second_s(lambda: prefill(params, prompt))
        cache = recache(cache)
        (step, _), dec_s = _second_s(lambda: decode(params, token, cache,
                                                     at))
        return layers.whole(logits), layers.whole(step), pre_s, dec_s

    plain = run(cfg, None, inputs, lambda c: c)
    mcfg = steps.mesh_cfg(cfg, mesh, B)
    shd.distribute_params(params, mesh)
    b = ("data",)
    inputs = steps.distribute_inputs(inputs, (
        shd.placements_tree(mesh, shd.batch_spec(mesh, inputs[0], B)),
        shd.placements((b, None), mesh), shd.placements((b,), mesh)), mesh)
    sharded = run(mcfg, mesh, inputs, lambda c: steps.redistribute_tree(
        c, shd.placements_tree(mesh, shd.cache_shardings(mesh, c, mcfg, B, True)),
        mesh))
    out = {"arch": SERVE_ARCH, "batch": B, "prompt": S,
           "prefill_bits_equal": bool(torch.equal(sharded[0], plain[0])),
           "decode_bits_equal": bool(torch.equal(sharded[1], plain[1])),
           "prefill_gap_share_of_max": _rel_err(sharded[0], plain[0]),
           "decode_gap_share_of_max": _rel_err(sharded[1], plain[1]),
           "prefill_s_plain": plain[2], "prefill_s_sharded": sharded[2],
           "decode_s_plain": plain[3], "decode_s_sharded": sharded[3]}
    if not (out["prefill_gap_share_of_max"] <= SHARDED_LOGIT_TOL
            and out["decode_gap_share_of_max"] <= SHARDED_LOGIT_TOL):
        raise AssertionError(f"sharded serve steps: {out}")
    return out


def _sharded_steps(seed: int) -> dict:
    """(b): the train and serve steps on a (1, 1) mesh of an NCCL world
    of one rank, each against the plain step on the same weights."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
        try:
            mesh = make_mesh((1, 1), ("data", "model"), device="cuda")
            out = {}
            for arch, n_layers in SHARDED_TRAIN:
                out[f"train:{arch}"] = _sharded_train(mesh, seed, arch,
                                                      n_layers)
                torch.cuda.empty_cache()
            out["serve"] = _sharded_serve(mesh, seed)
            torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()
    return out


def dryrun_path(seed: int) -> dict:
    """12: the dry-run CLI's cells (a), traced on the host while the
    sharded steps run on the card (b), with the card's name and power
    limit."""
    t0 = time.perf_counter()
    with _dryrun_cells() as cells:
        result = _sharded_steps(seed)
    result["dryrun"] = cells
    result["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    result["wall_s"] = time.perf_counter() - t0
    return result


# ---------------------------------------------------------------------------


def build_all() -> None:
    """Build every kernel library (one nvcc per source, all at once) and
    print the build time and each library's ptxas spill lines, each after
    the kernel they belong to."""
    from repro_torch.kernels import cuda_build
    t0 = time.perf_counter()
    libs = cuda_build.build(*cuda_build.SOURCES)
    spills = {}
    for lib in libs:
        log = lib.with_name(lib.name + ".log")
        kernel, found = "?", []
        for ln in (log.read_text().splitlines() if log.exists() else []):
            if "Function properties for" in ln:
                kernel = ln.split("Function properties for")[-1].strip()
            elif "spill" in ln and " 0 bytes spill stores" not in ln:
                found.append(f"{kernel}: {ln.strip()}")
        spills[lib.name] = found
    print(json.dumps({"build_s": time.perf_counter() - t0,
                      "ptxas_spill_lines": spills}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    sys.path.insert(0, os.path.join(HERE, "src"))
    import repro_torch  # noqa: F401 — fails outside a checkout of the repo
    import repro_torch.kernels as K
    if "jax" in sys.modules or "repro" in sys.modules:
        raise AssertionError("the port imported JAX or the JAX package")

    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    # each phase's seconds, from the end of the one before it
    phase_s, t_lap = {}, [time.perf_counter()]

    def lap(name: str) -> None:
        now = time.perf_counter()
        phase_s[name], t_lap[0] = now - t_lap[0], now

    build_all()
    lap("build")

    tally = Tally()
    fused_parity(tally)
    fused_wide_parity(tally)
    counting_parity(tally)
    segmented_parity(tally)
    segmented_wide_parity(tally)
    parity = tally.result()
    print(json.dumps({"parity": {k: f"{p}/{t}" for k, (p, t) in parity.items()}}),
          flush=True)
    for name, (p, t) in parity.items():
        if p != t:
            raise AssertionError(f"{name}: {t - p} of {t} cases differ from "
                                 f"the plain version")
    lap("parity")
    bad = signed_zero_path()
    print(json.dumps({"signed_zero_mismatches": bad}), flush=True)
    if bad:
        raise AssertionError("signed-zero answers differ between card and CPU")

    result, (x, pivots, want, want_multi, k) = main_path(args.seed)
    kernels = result.pop("kernels")
    gk_median_s = result["gk_select_median_s"]
    print(json.dumps({"main_path": result}), flush=True)
    lap("main_path")
    result, rows = counting_path(x, pivots, want, k)
    kernels += rows
    print(json.dumps({"counting_path": result}), flush=True)
    lap("counting_path")
    result = baselines_path(x, want_multi, gk_median_s)
    print(json.dumps({"baselines_path": result}), flush=True)
    lap("baselines_path")
    del x, pivots                # the grouped path's peak counts its own data
    torch.cuda.empty_cache()
    result, rows, (values, keys, want_grouped) = grouped_path(args.seed)
    kernels += rows
    print(json.dumps({"grouped_path": result}), flush=True)
    lap("grouped_path")
    x = _main_data(args.seed)    # the same array again, for the last paths
    result, service_launches = service_path(x, want, want_multi, gk_median_s,
                                            tally)
    print(json.dumps({"service_path": result}), flush=True)
    lap("service_path")
    result, tenant_launches = tenants_path(args.seed, tally)
    print(json.dumps({"tenants_path": result}), flush=True)
    lap("tenants_path")
    for row in kernels:
        row["service_launches_per_query"] = {
            f"{path}.{query}": counts["launches"][row["name"]]
            for path, per_query in (("service_path", service_launches),
                                    ("tenants_path", tenant_launches))
            for query, counts in per_query.items()
            if row["name"] in counts["launches"]}
    result = sharded_path(x, {"single": want, "multi": want_multi,
                              "grouped": want_grouped}, values, keys, tally)
    print(json.dumps({"sharded_path": result}), flush=True)
    lap("sharded_path")
    del x, values, keys
    torch.cuda.empty_cache()

    def serve_phase(name: str, run) -> None:
        """Run a serve phase, print its record and add its queries'
        launches to the kernels line."""
        result, per_query = run()
        print(json.dumps({name: result}), flush=True)
        lap(name)
        for row in kernels:
            row["service_launches_per_query"].update({
                f"{name}.{query}": counts["launches"][row["name"]]
                for query, counts in per_query.items()
                if row["name"] in counts["launches"]})

    serve_phase("serve_path", lambda: serve_path(args.seed, tally))
    for name, arch in FAMILY_ARCHS:
        serve_phase(name, lambda: family_serve_path(name, arch, args.seed,
                                                    tally))
    serve_phase("swa_serve_path", lambda: swa_serve_path(args.seed, tally))
    serve_phase("deepseek_serve_path", lambda: family_serve_path(
        "deepseek_serve_path", DEEPSEEK_ARCH, args.seed, tally,
        one_shot=True, rounds=DEEPSEEK_ROUNDS))
    K.reset_launches()
    result = train_path(args.seed)
    print(json.dumps({"train_path": result}), flush=True)
    lap("train_path")
    train_launches = K.launches()
    for name, arch in FAMILY_TRAIN_ARCHS:
        result = family_train_path(name, arch, args.seed)
        print(json.dumps({name: result}), flush=True)
        lap(name)
    for row in kernels:
        row["train_launches"] = train_launches.get(row["name"], 0)
    K.reset_launches()
    result = dryrun_path(args.seed)
    print(json.dumps({"dryrun_path": result}), flush=True)
    lap("dryrun_path")
    if any(K.launches().values()):
        raise AssertionError(f"dryrun_path launched {K.launches()}")
    parity = tally.result()
    for name, (p, t) in parity.items():
        if p != t:
            raise AssertionError(f"{name}: {t - p} of {t} cases differ from "
                                 f"the plain version")
    for row in kernels:
        row["parity_cases"] = "{}/{}".format(*parity[row["name"]])
    print(json.dumps({"phase_s": phase_s,
                      "smoke_s": time.perf_counter() - t_start}), flush=True)

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
