"""Build and load the port's CUDA sources.

Every source in ``csrc/`` is compiled with nvcc for ``sm_90a`` into a shared
library of its own at first use, under the git-ignored ``_build/``, and
loaded with ctypes: a plain C interface of raw pointers plus the current
stream, each C function returning a CUDA error code that ``check`` turns
into an exception.  A library's name carries a hash of its source, the
shared headers and the flags, so an edit builds anew.  nvcc's resource
report (``-Xptxas -v``) is kept beside each library as ``<library>.log``.

``build`` starts one nvcc per missing library, all at once, and waits for
them: ``chip_smoke.py`` builds every kernel that way before it runs any.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("fused_select.cu", "partition_count.cu", "band_count.cu",
           "byte_histogram.cu", "segmented_select.cu")

# ctypes argument codes of the C interfaces
P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

_loaded: dict = {}
_load_lock = threading.Lock()


def nvcc() -> str:
    """Path of nvcc: CUDA_HOME's, else the one on PATH; raises without one."""
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    found = shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                           "from source at first use")
    return found


def library_path(source: str) -> Path:
    """Where ``csrc/<source>`` builds to, for the current source and flags."""
    digest = hashlib.sha256((CSRC / source).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}_{digest.hexdigest()[:16]}.so"


def build(*sources: str) -> list:
    """Compile each source whose library is missing, one nvcc each, all
    started together; return the libraries' paths in order."""
    libs = [library_path(s) for s in sources]
    todo = [(s, lib) for s, lib in zip(sources, libs) if not lib.exists()]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        compiler = nvcc()
        procs = []
        for source, lib in todo:
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            procs.append((source, lib, tmp, subprocess.Popen(
                [compiler, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        failed = []
        for source, lib, tmp, proc in procs:
            _, err = proc.communicate()
            if proc.returncode:
                failed.append(f"nvcc failed on {source}:\n{err}")
                continue
            lib.with_name(lib.name + ".log").write_text(err)
            os.replace(tmp, lib)
        if failed:
            raise RuntimeError("\n".join(failed))
    return libs


def load(source: str, signatures: dict):
    """The ctypes library of ``csrc/<source>``, built if needed, with each
    ``name: (argtypes, restype)`` of ``signatures`` declared."""
    with _load_lock:
        lib = _loaded.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build(source)[0]))
            for name, (argtypes, restype) in signatures.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = restype
            _loaded[source] = lib
        return lib


def check(code: int, what: str) -> None:
    """Raise on a C entry point's return code: -1 for arguments the kernel
    refuses, any other non-zero value is a CUDA error."""
    if code == -1:
        raise ValueError(f"{what}: arguments out of the kernel's range")
    if code:
        raise RuntimeError(f"{what}: CUDA error {code}")


def stream(device) -> ctypes.c_void_p:
    """The current CUDA stream of ``device`` as a C pointer."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def aligned(x: torch.Tensor) -> torch.Tensor:
    """x contiguous and 16-byte aligned (the kernels load 16-byte vectors)."""
    x = x.contiguous()
    return x.clone() if x.data_ptr() % 16 else x


def stream_blocks(device, n_vectors: int, threads: int = 256,
                  per_sm: int = 8) -> int:
    """Blocks for a grid-stride pass over ``n_vectors`` 16-byte vectors."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(-(-n_vectors // threads), per_sm * sms))


def shard_blocks(device, shards: int, n_i: int) -> int:
    """Blocks per shard for ``segmented_select``'s (blocks, shards) grids:
    about four per SM in all, none with fewer than 16384 elements."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(-(-4 * sms // shards), -(-n_i // 16384), 65535))


# the C interfaces' dtype codes, and the unsigned sort keys of the band
# kernels' scratch buffers
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2,
              torch.float64: 3, torch.uint32: 4}
KEY_DTYPE = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
             torch.int32: torch.int32, torch.float64: torch.int64}
