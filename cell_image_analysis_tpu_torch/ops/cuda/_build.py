"""Build `csrc/*.cu` into one shared library and load it with ctypes.

One `nvcc` call compiles every source for `sm_90a` into
`build/torch_kernels/libcia_torch_kernels_<hash>.so` at the repository root
(listed in .gitignore).  `<hash>` covers the sources' contents, so an edit
rebuilds and an unchanged tree reuses the library.  The sources have a
plain C interface (no PyTorch headers), which keeps the build to seconds.

Every C entry point takes its pointers and the CUDA stream as `void*`,
launches on that stream, and returns `cudaGetLastError()`; `check` raises
when it is not 0.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C signatures of the entry points (all return cudaError_t as int)
_SIGNATURES = {
    "cia_winograd_conv3x3": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "cia_segment_sum_i64": [_P, _P, _P, _L, _I, _I, _P],
    "cia_clahe_core": [_P, _P, _I, _P, _P, _P, _I, _P, _P, _I, _I, _P, _P],
}

_LIB = None
build_seconds: float | None = None  # wall time of the nvcc call, None if reused


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(SRC_DIR, "*.cu")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path() -> str:
    h = hashlib.sha256()
    for p in _sources():
        h.update(os.path.basename(p).encode())
        with open(p, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libcia_torch_kernels_{h.hexdigest()[:16]}.so")


def build(verbose: bool = False) -> str:
    """Compile the sources unless the library for their hash exists."""
    global build_seconds
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, *_sources()]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    if verbose:
        print(proc.stderr, end="")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build())
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: launch failed with cudaError_t {err}")
