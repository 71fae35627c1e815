"""Build `csrc/*.cu` into one shared library and load it with ctypes.

One `nvcc` process a source, all started together, compiles each for
`sm_90a` into an object file; one more links them into
`build/torch_kernels/libcia_torch_kernels_<hash>.so` at the repository root
(listed in .gitignore).  `<hash>` covers the sources' contents, so an edit
rebuilds and an unchanged tree reuses the library.  The sources have a
plain C interface (no PyTorch headers), which keeps the build to seconds.
`cached_build` and `load` are the hash-keyed build and the ctypes load for
any such library; `host_library` builds a host C++ source with g++
through them into `build/host_native/` (the SMO solver, `models/smo.py`;
the TIFF strip decoders, `io/tiff.py`).

Every C entry point that launches takes its pointers and the CUDA stream
as `void*`, launches on that stream, and returns `cudaGetLastError()`;
`check` raises when it is not 0.  `NVCC_FLAGS` has no `--use_fast_math`:
the CLAHE kernel's float divisions must stay IEEE.  Nothing here runs at
import time.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time
from typing import Callable

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# C signatures of the entry points (all return an int: cudaError_t, or a size)
_SIGNATURES = {
    "cia_winograd_conv3x3": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "cia_segment_sum_i64": [_P, _P, _P, _L, _I, _I, _P],
    "cia_clahe_cells": [_P, _I, _I, _P, _I, _P, _P, _I, _I, _F, _I, _I, _P, _P],
    "cia_cc_label_components": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "cia_kthvalue_radix": [_P, _L, _I, _I, _P, _I, _P, _I, _P, _L, _P, _P],
    "cia_kthvalue_radix_scratch_words": [_I, _I],
    "cia_follow_flows": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "cia_vit_attention": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
    "cia_vit_linear": [_P, _P, _P, _P, _I, _I, _I, _P],
}

HOST_BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "host_native")
HOST_CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-ffp-contract=off"]

_LIB = None
build_seconds: float | None = None  # wall time of the nvcc calls, None if reused


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


def cached_build(sources: list[str], compiler: Callable[[], str], flags: list[str],
                 build_dir: str, stem: str, extra: tuple[str, ...] = (),
                 verbose: bool = False) -> tuple[str, float | None]:
    """Build `sources` into `build_dir/<stem>_<hash>.so` unless it exists.

    One `compiler() *flags *extra -c` process a source, all started
    together, then one `compiler() *flags -shared` link, written to a
    temporary name and moved into place.  `<hash>` covers the sources'
    names and contents and `flags`, not `extra`.  `compiler` is called only
    when a build is needed.  Returns (path, seconds of the build, or None
    when the library was reused); RuntimeError when a step fails.
    """
    h = hashlib.sha256()
    for p in sources:
        h.update(os.path.basename(p).encode())
        with open(p, "rb") as f:
            h.update(f.read())
    h.update(" ".join(flags).encode())
    out = os.path.join(build_dir, f"{stem}_{h.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out, None
    cc = compiler()
    os.makedirs(build_dir, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    objs = [f"{tmp}.{os.path.basename(src)}.o" for src in sources]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([cc, *flags, *extra, "-c", "-o", obj, src],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for src, obj in zip(sources, objs)]
    steps = [(src, *proc.communicate(), proc.returncode) for src, proc in zip(sources, procs)]
    if all(rc == 0 for *_, rc in steps):
        link = subprocess.run([cc, *flags, "-shared", "-o", tmp, *objs],
                              capture_output=True, text=True)
        steps.append(("link", link.stdout, link.stderr, link.returncode))
    seconds = time.perf_counter() - t0
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    for src, _, err, rc in steps:
        if rc != 0:
            raise RuntimeError(
                f"{os.path.basename(cc)} failed on {os.path.basename(src)} ({rc}):\n{err}")
        if verbose:
            print(err, end="")
    os.replace(tmp, out)
    return out, seconds


def load(path: str, signatures: dict, restype=ctypes.c_int) -> ctypes.CDLL:
    """`ctypes.CDLL(path)` with each entry point's argtypes and `restype`."""
    lib = ctypes.CDLL(path)
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def host_cxx() -> str:
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("the port's host C++ libraries (the SMO solver, the TIFF strip "
                           "decoders) need a C++ compiler: g++ was not found")
    return cxx


def host_library(source: str, stem: str, signatures: dict, restype=ctypes.c_long) -> ctypes.CDLL:
    """`source` built by g++ (`HOST_CXX_FLAGS`) into `HOST_BUILD_DIR` unless
    the library for its hash exists, and loaded; RuntimeError when there is
    no g++ or the compile fails."""
    path, _ = cached_build([source], host_cxx, HOST_CXX_FLAGS, HOST_BUILD_DIR, stem)
    return load(path, signatures, restype=restype)


def build(verbose: bool = False) -> str:
    """Compile the sources unless the library for their hash exists."""
    global build_seconds
    out, seconds = cached_build(_sources(), _nvcc, NVCC_FLAGS, BUILD_DIR, "libcia_torch_kernels",
                                extra=("-Xptxas", "-v") if verbose else (), verbose=verbose)
    if seconds is not None:
        build_seconds = seconds
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _LIB
    if _LIB is None:
        _LIB = load(build(), _SIGNATURES)
    return _LIB


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def c_ints(what: str, **values: int) -> None:
    """Raises where a value for a C `int` argument of a kernel's entry
    point lies outside int32: ctypes would wrap it silently."""
    bad = {k: v for k, v in values.items() if not -2 ** 31 <= int(v) < 2 ** 31}
    if bad:
        raise ValueError(f"{what}: {bad} outside the kernel's 32-bit int arguments")


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: launch failed with cudaError_t {err}")
