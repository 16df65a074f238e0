"""Fault tolerance and elasticity, in PyTorch: preemption handling,
straggler detection, elastic rescale planning.  Counterpart of
``repro/distributed/fault_tolerance.py``.

The pieces are plain state machines that the training loop calls; a
cluster's launcher wires them to SIGTERM, its coordination service and its
scheduler.  Straggler detection uses the paper's primitive: per-step
durations stream into a ``QuantileService`` stream, and a host is flagged
when it exceeds the exact windowed p99 step time by a margin (a warm query,
no sort a decision).  On the job's shared service the stream rides the
service snapshot (``checkpoint.save_service_snapshot``), so a restored job
flags from the same duration distribution.
"""
from __future__ import annotations

import dataclasses
import signal
import threading
from typing import Dict, List, Optional

import numpy as np


class PreemptionHandler:
    """SIGTERM-aware graceful shutdown: flip a flag, and let the training
    loop checkpoint at the next step boundary."""

    def __init__(self, install_signal: bool = False):
        self._flag = threading.Event()
        if install_signal:
            signal.signal(signal.SIGTERM, lambda *_: self._flag.set())

    def preempt(self) -> None:
        self._flag.set()

    @property
    def should_stop(self) -> bool:
        return self._flag.is_set()


class StragglerMonitor:
    """Quantile-based straggler detection over per-host step durations.

    A host is a straggler when its step time exceeds ``factor`` times the
    ``quantile`` of the step durations over the last ``window`` recorded
    steps (ticks); ``window=None`` takes the whole history.  The durations
    live in the stream ``"step_durations"`` of a ``QuantileService``: a
    private one on ``device`` (windowed unless ``window`` is None), or the
    job's shared ``service``.  ``decide`` answers with the service's exact
    warm (windowed) quantile and never mutates: an unfed monitor creates no
    stream, and its queries read committed state only
    (``commit=False``)."""

    STREAM = "step_durations"

    def __init__(self, quantile: float = 0.99, factor: float = 2.0,
                 eps: float = 0.01, min_samples: int = 64, service=None,
                 window: Optional[int] = 256, window_subs: int = 8,
                 device="cuda"):
        from ..launch.quantile_service import QuantileService
        if service is None:
            service = (QuantileService(eps=eps, window_ticks=window,
                                       window_subs=window_subs,
                                       device=device)
                       if window is not None
                       else QuantileService(eps=eps, device=device))
        self.service = service
        # clamp to the service's retention: a shared service may keep less
        # history than asked for; an unwindowed one answers any window
        svc_window = getattr(service, "window_ticks", None)
        if svc_window is not None:
            window = svc_window if window is None else min(window,
                                                           svc_window)
        self.window = window
        self.quantile = quantile
        self.factor = factor
        self.min_samples = min_samples

    def record(self, durations: Dict[str, float]) -> None:
        """Feed one step's per-host durations (one service tick); an empty
        mapping does nothing."""
        if not durations:
            return
        self.service.ingest(
            self.STREAM,
            np.asarray(list(durations.values()), dtype=np.float32))

    def decide(self, durations: Dict[str, float]) -> List[str]:
        """The hosts above ``factor`` times the (windowed) quantile;
        reads committed state only."""
        if self.window is not None:
            if (self.service.window_count(self.STREAM, window=self.window)
                    < self.min_samples):
                return []
            p = self.service.windowed(self.STREAM, self.quantile,
                                      window=self.window, commit=False)
        else:
            if self.service.stream_count(self.STREAM) < self.min_samples:
                return []
            p = self.service.exact(self.STREAM, self.quantile,
                                   commit=False)
        thr = self.factor * float(p)
        return [h for h, d in durations.items() if d > thr]


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    """Rescale decision: the new mesh shape and whether a restore is
    needed.  The model axis stays whole (its shards hold state); the data
    and pod axes absorb node loss in whole multiples, so the new data
    parallelism is the largest divisor of the surviving groups that divides
    the global batch."""
    data: int
    model: int
    pods: int
    restore_from_checkpoint: bool


def plan_rescale(alive_chips: int, model_parallel: int, global_batch: int,
                 chips_per_pod: int = 256) -> ElasticPlan:
    if alive_chips < model_parallel:
        raise RuntimeError("fewer chips than one model-parallel group")
    groups = alive_chips // model_parallel
    data = groups
    while data > 1 and global_batch % data:
        data -= 1
    pods = max(1, (data * model_parallel) // chips_per_pod)
    return ElasticPlan(data=data, model=model_parallel, pods=pods,
                       restore_from_checkpoint=True)


class StepBarrier:
    """Deterministic skip protocol: when any host misses the deadline,
    every host skips the same step (the pipeline is index-addressable, so
    the skip is consistent by construction)."""

    def __init__(self, deadline_s: float):
        self.deadline_s = deadline_s
        self.skipped_steps: List[int] = []

    def check(self, step: int, slowest_host_s: float) -> bool:
        """True if the step should be skipped cluster-wide."""
        if slowest_host_s > self.deadline_s:
            self.skipped_steps.append(step)
            return True
        return False
