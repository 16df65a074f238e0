"""Hopper kernels for the fused count + candidate-band round.

``fused_select``        replaces ``repro/kernels/fused_select.py::fused_select``
                        (``_fused_kernel``): for every shard of a (P, n_i)
                        batch, the int32 (lt, eq, gt) counts against one pivot
                        plus both capped candidate bands.
``fused_select_multi``  replaces ``::fused_select_multi``
                        (``_fused_multi_kernel``): the same for Q pivots from
                        the same passes over the data (up to 8 pivots a call).

Both are one CUDA C++ source, ``csrc/fused_select.cu``, compiled with nvcc
for ``sm_90a`` into a shared library at first use and bound with ctypes (a
plain C interface: raw pointers plus the current stream; the C function
returns the CUDA error code and the wrapper raises on anything but 0).  The
source's header says what bounds the kernels and how the design answers it.
Plain versions: ``kernels/ref.py``.

A wrapper takes CUDA tensors only and raises otherwise; choosing the plain
version for a CPU tensor is ``kernels/dispatch.py``'s job.  Every launch adds
one to its kernel's count in ``LAUNCHES``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

SOURCE = Path(__file__).with_name("csrc") / "fused_select.cu"
BUILD_DIR = Path(__file__).with_name("_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

MULTI_MAX_PIVOTS = 8            # pivots one fused_select_multi launch takes
PASSES_PER_LAUNCH = 2           # full reads of the data per launch
_BLOCKS_PER_SM = 4
_MIN_BLOCK_ELEMS = 16384

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2,
               torch.float64: 3}
_KEY_DTYPE = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
              torch.int32: torch.int32, torch.float64: torch.int64}

LAUNCHES = {"fused_select": 0, "fused_select_multi": 0}
_lib_handle = None


def reset_launches() -> None:
    """Zero both kernels' launch counts."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launches() -> dict:
    """Launches of each kernel since the last reset."""
    return dict(LAUNCHES)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    found = shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found: the fused_select kernels are "
                           "built from source at first use")
    return found


def build() -> Path:
    """Compile ``csrc/fused_select.cu`` (once per source and flag set) and
    return the shared library's path.  nvcc's resource report (``-Xptxas
    -v``) is kept beside it as ``<library>.log``."""
    tag = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"fused_select_{tag}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {SOURCE.name}:\n{proc.stderr}")
    lib.with_name(lib.name + ".log").write_text(proc.stderr)
    os.replace(tmp, lib)
    return lib


def _lib():
    global _lib_handle
    if _lib_handle is None:
        lib = ctypes.CDLL(str(build()))
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.fs_count.argtypes = [i32, i32, vp, i64, i64, vp, i32, i32, i32,
                                 vp, vp, vp, vp, vp, vp, vp]
        lib.fs_count.restype = i32
        lib.fs_compact.argtypes = [i32, i32, vp, i64, i64, vp, i32, i32, i32,
                                   vp, vp, vp, vp, vp, i64, i32, vp, vp]
        lib.fs_compact.restype = i32
        lib.fs_sort_emit.argtypes = [i32, i32, i64, vp, vp, i64, i64, i64, vp,
                                     vp, vp]
        lib.fs_sort_emit.restype = i32
        for layout in (lib.fs_num_bins, lib.fs_sort_tile):
            layout.argtypes = []
            layout.restype = i32
        _lib_handle = lib
    return _lib_handle


def _check(code: int, what: str) -> None:
    if code == -1:
        raise ValueError(f"{what}: arguments out of the kernel's range")
    if code:
        raise RuntimeError(f"{what}: CUDA error {code}")


def _prepare(x: torch.Tensor, pivots: torch.Tensor, cap: int):
    if not x.is_cuda:
        raise ValueError(f"fused_select kernels take CUDA tensors, got "
                         f"{x.device}")
    if x.dim() != 2:
        raise ValueError(f"x must be (P, n_i), got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"unsupported dtype {x.dtype}")
    P, n_i = x.shape
    if not (1 <= P <= 65535 and 1 <= n_i < 2 ** 31):
        raise ValueError(f"shape {tuple(x.shape)} outside P <= 65535, "
                         f"n_i < 2^31")
    if not 1 <= cap <= n_i:
        raise ValueError(f"cap must be in [1, {n_i}], got {cap}")
    x = x.contiguous()
    if x.data_ptr() % 16:           # the kernels load 16-byte vectors
        x = x.clone()
    pivots = pivots.reshape(-1).to(device=x.device, dtype=x.dtype).contiguous()
    if pivots.numel() < 1:
        raise ValueError("at least one pivot is needed")
    return x, pivots


def _pow2_at_least(n: int) -> int:
    return 1 << (max(1, n) - 1).bit_length()


def _launch(x: torch.Tensor, pivots: torch.Tensor, cap: int, maxq: int):
    """One launch: two passes over x for up to ``maxq`` pivots."""
    P, n_i = x.shape
    Q = pivots.numel()
    dev = x.device
    lib = _lib()
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        bps = max(1, min(-(-_BLOCKS_PER_SM * sms // P),
                         -(-n_i // _MIN_BLOCK_ELEMS), 65535))
        i32 = dict(dtype=torch.int32, device=dev)
        hist = torch.zeros((P, Q, 2, lib.fs_num_bins()), **i32)
        eq = torch.zeros((P, Q), **i32)
        thr = torch.empty((P, Q, 2), **i32)
        cand = torch.empty((P, Q, 2), **i32)
        counts = torch.empty((P, Q, 3), **i32)
        max_cand = torch.zeros((1,), **i32)
        code = _DTYPE_CODE[x.dtype]
        _check(lib.fs_count(code, maxq, x.data_ptr(), P, n_i,
                            pivots.data_ptr(), Q, cap, bps, hist.data_ptr(),
                            eq.data_ptr(), thr.data_ptr(), cand.data_ptr(),
                            counts.data_ptr(), max_cand.data_ptr(), stream),
               "fused_select count pass")
        # the scratch rows are as wide as the fullest band, a power of two
        # of at least one sort tile: the first host sync of the launch
        tile = lib.fs_sort_tile()
        L = max(_pow2_at_least(int(max_cand.item())), tile)
        # trimming the bands to about cap pays only when it can shorten
        # the sorted rows
        trim = L > max(_pow2_at_least(cap), tile)
        rows = P * Q * 2
        buf = torch.full((rows, L), -1, dtype=_KEY_DTYPE[x.dtype], device=dev)
        cursor = torch.zeros((rows,), **i32)
        max_kept = torch.zeros((1,), **i32)
        _check(lib.fs_compact(code, maxq, x.data_ptr(), P, n_i,
                              pivots.data_ptr(), Q, cap, bps, hist.data_ptr(),
                              thr.data_ptr(), cand.data_ptr(),
                              cursor.data_ptr(), buf.data_ptr(), L, int(trim),
                              max_kept.data_ptr(), stream),
               "fused_select compaction pass")
        # the trimmed bands set how much of each row the sort covers: a
        # second host sync
        length = (max(_pow2_at_least(int(max_kept.item())), tile) if trim
                  else L)
        below = torch.empty((P, Q, cap), dtype=x.dtype, device=dev)
        above = torch.empty((P, Q, cap), dtype=x.dtype, device=dev)
        _check(lib.fs_sort_emit(code, maxq, rows, cand.data_ptr(),
                                buf.data_ptr(), L, length, cap,
                                below.data_ptr(), above.data_ptr(), stream),
               "fused_select band sort")
    return counts, below, above


def fused_select(x: torch.Tensor, pivot: torch.Tensor, cap: int):
    """Counts and both capped bands of every shard of a (P, n_i) CUDA batch
    against one pivot: ``(counts (P, 3) int32, below (P, cap), above (P,
    cap))`` with ``ref.fused_select_ref`` semantics, bit for bit."""
    x, pivots = _prepare(x, pivot, cap)
    if pivots.numel() != 1:
        raise ValueError("fused_select takes one pivot")
    counts, below, above = _launch(x, pivots, cap, maxq=1)
    LAUNCHES["fused_select"] += 1
    return counts[:, 0], below[:, 0], above[:, 0]


def fused_select_multi(x: torch.Tensor, pivots: torch.Tensor, cap: int):
    """``fused_select`` against Q pivots: ``(counts (P, Q, 3), below (P, Q,
    cap), above (P, Q, cap))``.  Each launch serves up to
    ``MULTI_MAX_PIVOTS`` pivots; more pivots take more launches."""
    x, pivots = _prepare(x, pivots, cap)
    outs = []
    for start in range(0, pivots.numel(), MULTI_MAX_PIVOTS):
        outs.append(_launch(x, pivots[start:start + MULTI_MAX_PIVOTS], cap,
                            maxq=MULTI_MAX_PIVOTS))
        LAUNCHES["fused_select_multi"] += 1
    if len(outs) == 1:
        return outs[0]
    return tuple(torch.cat(parts, dim=1) for parts in zip(*outs))


def launches_for(num_pivots: int) -> int:
    """Launches ``fused_select_multi`` makes for ``num_pivots`` pivots."""
    return -(-num_pivots // MULTI_MAX_PIVOTS)
