"""Hopper kernels for GK Select's count+extract round, and their plain
PyTorch versions.

fused_select  the two CUDA kernels (``fused_select``, ``fused_select_multi``),
              their nvcc build and ctypes binding, launch counters
ref           plain PyTorch versions: the kernels' contract and CPU path
dispatch      device -> implementation (CPU: plain, CUDA: kernel or raise)
ops           batched wrappers, full-read counter, order-preserving keys
"""
from . import dispatch, fused_select, ops, ref

__all__ = ["dispatch", "fused_select", "ops", "ref"]
