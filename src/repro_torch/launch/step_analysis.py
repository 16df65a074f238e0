"""Per-rank cost analysis of one eager step: FLOPs, memory traffic and
collectives, counted op by op on this rank's shards.

Counterpart of ``repro/launch/hlo_analysis.py``, which parses the
partitioned HLO module of a compiled step.  Here the step runs eagerly
under a ``TorchDispatchMode`` on one rank of the world (a fake process
group of 256 or 512 ranks in the dry-run, a real one in a test), and
every ATen op that reaches the mode is counted:

  * dot/conv FLOPs      matmuls (mm, addmm, bmm, baddbmm, ...) and
                        convolutions, forward and backward, at the shapes
                        of this rank's local shards (a DTensor op reaches
                        the mode only after DTensor has split it into its
                        local op and the collectives it needs, so a
                        product sharded 256 ways counts 1/256 of the
                        global FLOPs, as the reference's per-device HLO
                        shapes do)
  * memory traffic      operand and result bytes of every non-view op.
                        Eager PyTorch does not fuse, so every
                        intermediate goes through memory: an upper bound
                        where the reference counts fusion boundaries only
  * collective bytes    the ``c10d_functional`` collectives DTensor
                        issues, by the reference's five kinds, counted as
                        its parser counts operand bytes from the result:
                        all-gather result / group, reduce-scatter result
                        x group, all-reduce, all-to-all and
                        collective-permute the result
  * collective result   the bytes each collective writes on this rank,
    bytes               by kind: an all-gather's whole result (its
                        operand bytes x the group: what the rank
                        receives and its own piece), which the
                        reference's operand bytes leave out
  * collective counts
  * peak live bytes     of the tensors the step made (each storage once,
                        from its first op to its release): the
                        counterpart of XLA's temp bytes
  * peak tensors        the largest of them live at the peak: bytes,
                        local shape and dtype, the op that made it, the
                        innermost line of the package that called it, and
                        the global shape and placements where a DTensor
                        op (not a backward) made it

Eager execution runs every layer (there is no scan to unroll), so the
reference's while-loop trip counts have no counterpart: every figure is
already the whole step's.  DTensor's own sharding propagation runs ops on
fake global-shape tensors to learn output shapes; those are not the
step's work and are skipped.
"""
from __future__ import annotations

import heapq
import os
import sys
import weakref
from typing import Dict

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

__all__ = ["COLLECTIVES", "analyze", "StepAnalysis"]

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# c10d functional op name -> the reference's kind
_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
    "permute_tensor": "collective-permute",
}
_C10D_NAMESPACES = ("_c10d_functional", "c10d_functional",
                    "_c10d_functional_autograd")
# ops that move no data: views, aliases, allocation without a write, and
# the wait on a collective's result
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "detach", "alias",
               "lift_fresh", "_local_scalar_dense", "wait_tensor",
               "_unsafe_view", "view", "_reshape_alias", "as_strided",
               "expand", "permute", "transpose", "t", "slice", "select",
               "unsqueeze", "squeeze", "unbind", "split", "chunk",
               "split_with_sizes", "narrow", "view_as", "reshape"}
# DTensor's sharding propagation (fake global-shape ops, not the step's)
_PROPAGATION = ("_propagate_tensor_meta_non_cached", "_propagate_tensor_meta")
_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PEAK_TENSORS = 8          # the largest live tensors kept at the peak


def _in_propagation() -> bool:
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_name in _PROPAGATION:
            return True
        f = f.f_back
    return False


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def _group_size(func, args, kwargs) -> int:
    """The ``group_size`` argument of a c10d functional op, by name (the
    native and the legacy ops put it in different places)."""
    for i, a in enumerate(func._schema.arguments):
        if a.name == "group_size":
            return int(args[i] if i < len(args) else kwargs["group_size"])
    raise ValueError(f"{func} takes no group_size")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _caller() -> str:
    """The innermost frame of the package outside this module, as
    ``file:line function``."""
    f = sys._getframe(2)
    while f is not None:
        path = f.f_code.co_filename
        if path.startswith(_PACKAGE) and path != __file__:
            return (f"{os.path.relpath(path, _PACKAGE)}:{f.f_lineno} "
                    f"{f.f_code.co_name}")
        f = f.f_back
    return "?"


class _Placements(TorchFunctionMode):
    """Notes the global shape and placements of each DTensor that a torch
    call returns, under its local shard's storage, for the storages that
    ``owner`` tracks (the backward's DTensors do not pass through here)."""

    def __init__(self, owner: "StepAnalysis"):
        super().__init__()
        self.owner = owner

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        from torch.distributed.tensor import DTensor
        for t in _tensors(out):
            if isinstance(t, DTensor):
                info = self.owner.info.get(
                    t._local_tensor.untyped_storage()._cdata)
                if info is not None and "placements" not in info:
                    info["global_shape"] = list(t.shape)
                    info["placements"] = [str(p) for p in t.placements]
        return out


class StepAnalysis(TorchDispatchMode):
    """The counters of ``analyze``, as a dispatch mode: enter it around
    any eager code and read ``result()``."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.traffic = 0
        self.coll_bytes = {k: 0 for k in COLLECTIVES}
        self.coll_result = {k: 0 for k in COLLECTIVES}
        self.coll_count = {k: 0 for k in COLLECTIVES}
        self.live = {}            # storage -> bytes, while it lives
        self.info = {}            # storage -> what made it, while it lives
        self.live_bytes = 0
        self.peak_bytes = 0
        self.peak_tensors = []
        self._noted = 0           # live bytes when peak_tensors was taken
        self._placements = _Placements(self)

    def __enter__(self):
        self._placements.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._placements.__exit__(*exc)

    def _track(self, out, func) -> None:
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in self.live:
                continue
            self.live[key] = n = st.nbytes()
            self.info[key] = {"bytes": n, "shape": list(t.shape),
                              "dtype": str(t.dtype).replace("torch.", ""),
                              "op": str(func), "at": _caller()}
            self.live_bytes += n
            if self.live_bytes > self.peak_bytes:
                self.peak_bytes = self.live_bytes
                # a new list of the largest only past 1/1000 of growth
                # (every op of a rising step would make one)
                if self.live_bytes > self._noted * 1.001:
                    self._note_peak()
            weakref.finalize(st, self._release, key)

    def _note_peak(self) -> None:
        self._noted = self.live_bytes
        self.peak_tensors = [self.info[k] for k in heapq.nlargest(
            PEAK_TENSORS, self.live, key=self.live.get)]

    def _release(self, key) -> None:
        self.live_bytes -= self.live.pop(key, 0)
        self.info.pop(key, None)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            # let DTensor split the op into its local op and collectives,
            # which come back through this mode on plain tensors
            return NotImplemented
        out = func(*args, **kwargs)
        if isinstance(func, torch._ops.HigherOrderOperator) \
                or _in_propagation():
            return out
        ns = func.namespace
        name = func._overloadpacket.__name__
        self._track(out, func)
        if ns in _C10D_NAMESPACES:
            self._collective(func, args, kwargs, out)
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        if name not in _NO_TRAFFIC and not func.is_view:
            self.traffic += sum(_nbytes(t) for t in _tensors(args)) \
                + sum(_nbytes(t) for t in _tensors(kwargs)) \
                + sum(_nbytes(t) for t in _tensors(out))
        return out

    def _collective(self, func, args, kwargs, out) -> None:
        name = func._overloadpacket.__name__
        if name in ("wait_tensor", "_wrap_tensor_autograd"):
            return
        if name not in _KINDS:
            raise NotImplementedError(f"collective {name} has no kind in the "
                                      f"reference's accounting")
        kind = _KINDS[name]
        rb = sum(_nbytes(t) for t in _tensors(out))
        if kind == "all-gather":
            b = rb // max(1, _group_size(func, args, kwargs))
        elif kind == "reduce-scatter":
            b = rb * _group_size(func, args, kwargs)
        else:
            b = rb
        self.coll_bytes[kind] += b
        self.coll_result[kind] += rb
        self.coll_count[kind] += 1

    def result(self) -> Dict:
        return {
            "flops": float(self.flops),
            "traffic_bytes": float(self.traffic),
            "collective_bytes": {k: float(v)
                                 for k, v in self.coll_bytes.items()},
            "collective_counts": {k: float(v)
                                  for k, v in self.coll_count.items()},
            "collective_total_bytes": float(sum(self.coll_bytes.values())),
            "collective_result_bytes": {k: float(v)
                                        for k, v in self.coll_result.items()},
            "peak_bytes": float(self.peak_bytes),
            "peak_tensors": [dict(t) for t in self.peak_tensors],
        }


def analyze(fn, *args, **kwargs) -> Dict:
    """Run ``fn(*args, **kwargs)`` once under ``StepAnalysis`` and return
    the reference's keys: ``flops``, ``traffic_bytes``,
    ``collective_bytes`` and ``collective_counts`` (by kind) and
    ``collective_total_bytes``, all per rank, ``collective_result_bytes``
    (by kind), ``peak_bytes`` and
    ``peak_tensors``.  The
    step's output is under ``"out"``."""
    mode = StepAnalysis()
    with mode:
        out = fn(*args, **kwargs)
    return {**mode.result(), "out": out}
