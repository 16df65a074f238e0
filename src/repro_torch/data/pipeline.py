"""Deterministic, shardable synthetic data pipeline with exact resume, the
port's own copy of ``repro/data/pipeline.py`` (numpy only).

Every batch is a pure function of (seed, step, shard), so any shard can be
regenerated on any host, resume after preemption is an integer cursor, and
a step can be skipped on all hosts alike.  The token stream is
Zipf-distributed over the vocabulary (power-law vocabulary use, the
paper's robustness distribution).  ``StreamStats`` keeps a GK sketch of
the per-step losses on the host.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

from ..core.sketch import GKSketch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_s: float = 1.2          # Fig 3-4's power-law regime
    frontend_len: int = 0        # vision stub positions
    enc_seq: int = 0             # audio stub frames
    d_model: int = 0             # frontend embedding width


class SyntheticPipeline:
    """Index-addressable batch source: ``batch_at(step)`` is
    deterministic."""

    def __init__(self, cfg: DataConfig, shard_index: int = 0,
                 num_shards: int = 1):
        if cfg.global_batch % num_shards:
            raise ValueError("global_batch must divide across data shards")
        self.cfg = cfg
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.local_batch = cfg.global_batch // num_shards
        self._step = 0
        # Zipf CDF over the vocab (stationary, precomputed once)
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        w = ranks ** (-cfg.zipf_s)
        self._cdf = np.cumsum(w / w.sum())

    @property
    def step(self) -> int:
        return self._step

    def seek(self, step: int) -> None:
        """Exact resume: set the cursor (a checkpoint stores it)."""
        self._step = int(step)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, self.shard_index]))
        u = rng.random((self.local_batch, cfg.seq_len + 1))
        toks = np.searchsorted(self._cdf, u).astype(np.int32)
        toks = np.clip(toks, 0, cfg.vocab - 1)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
        if cfg.frontend_len and cfg.d_model:
            out["patch_embeds"] = rng.standard_normal(
                (self.local_batch, cfg.frontend_len, cfg.d_model)
            ).astype(np.float32) * 0.02
            out["labels"][:, :cfg.frontend_len] = -1   # no loss on patches
        if cfg.enc_seq and cfg.d_model:
            out["frames"] = rng.standard_normal(
                (self.local_batch, cfg.enc_seq, cfg.d_model)
            ).astype(np.float32) * 0.02
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.batch_at(self._step)
            self._step += 1


class StreamStats:
    """Streaming statistics over per-token losses on the host's GK sketch:
    skew monitoring for the data pipeline (paper §IV-D applied to
    training)."""

    def __init__(self, eps: float = 0.01):
        self.sketch = GKSketch(eps, head_size=4096, compress_threshold=1024)

    def update(self, values: np.ndarray) -> None:
        self.sketch.insert_batch(np.asarray(values, np.float64).ravel())

    def quantile(self, q: float) -> float:
        return self.sketch.query(q)
