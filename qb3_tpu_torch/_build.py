"""Build and load the package's CUDA kernels (csrc/*.cu).

nvcc compiles every source in one call into a shared library with a plain C
interface for sm_90a (H100), which ctypes loads.  The library is built at
first use into build/qb3_tpu_torch/ beside the package, named by a hash of
the sources and flags, so an edited source rebuilds and an unchanged one
loads at once.  Nothing here runs at import time: the CPU tests import every
module on machines without nvcc.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "qb3_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
# C entry point -> argument types; every entry point returns cudaGetLastError()
SIGNATURES = {
    "qb3_pack_groups": [_P, _P, _P, _I64, _I32, _I64, _I64, _P, _P],
    "qb3_extract_windows": [_P, _I64, _P, _I32, _I32, _P, _P],
    "qb3_chunkwalk": [_P, _I64, _P, _P, _I32, _P, _P, _I64, _I32, _I32, _I32,
                      _I32, _P, _P],
}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def build() -> str:
    """Compile csrc/*.cu unless a library for these sources exists; returns
    its path.  The compiler's report (ptxas registers and spills) is kept
    beside it as <library>.log."""
    sources = sorted(glob.glob(os.path.join(SRC_DIR, "*.cu")))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(SRC_DIR, "*.cu*"))):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + f.read())
    lib = os.path.join(BUILD_DIR, f"libqb3_tpu_torch_{h.hexdigest()[:16]}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *sources],
                          capture_output=True, text=True)
    with open(lib + ".log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
    return lib


@functools.cache
def load() -> ctypes.CDLL:
    """The kernel library, built on first call."""
    lib = ctypes.CDLL(build())
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")
