"""Hopper kernels for GK Select, and their plain PyTorch versions.

fused_select      ``fused_select``, ``fused_select_multi`` and
                  ``byte_histogram`` (with the 4-pass radix walk)
partition_count   ``partition_count`` (with the 32-pass bitwise search)
band_count        ``band_count``
segmented_select  ``segmented_select``, the grouped engine's round
band_sort         the band kernels' trim and sort: host plan and launches
cuda_build        nvcc build of ``csrc/*.cu`` and the ctypes binding
ref               plain PyTorch versions: the kernels' contract and CPU path
dispatch          device -> implementation (CPU: plain, CUDA: kernel or raise)
ops               batched wrappers, full-read counter, order-preserving keys,
                  radix selects

Each kernel module counts its launches in ``LAUNCHES``.
"""
from . import (band_count, cuda_build, dispatch, fused_select, ops,
               partition_count, ref, segmented_select)

KERNEL_MODULES = (fused_select, partition_count, band_count, segmented_select)


def reset_launches() -> None:
    """Zero every kernel's launch count."""
    for module in KERNEL_MODULES:
        for name in module.LAUNCHES:
            module.LAUNCHES[name] = 0


def launches() -> dict:
    """Launches of every kernel since the last reset, by kernel name."""
    return {name: count for module in KERNEL_MODULES
            for name, count in module.LAUNCHES.items()}


__all__ = ["band_count", "cuda_build", "dispatch", "fused_select", "ops",
           "partition_count", "ref", "segmented_select", "KERNEL_MODULES",
           "reset_launches", "launches"]
