"""Build and load the package's CUDA kernels (csrc/*.cu).

nvcc compiles every source, one process per source, all at once, and links
them into a shared library with a plain C interface for sm_90a (H100), which
ctypes loads.  The library is built at first use into build/qb3_tpu_torch/
beside the package, named by a hash of the sources and flags, so an edited
source rebuilds and an unchanged one loads at once.  Nothing here runs at import time: the CPU tests import every
module on machines without nvcc.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "qb3_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I64, _I32, _U64 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_uint64
# C entry point -> argument types; every entry point returns cudaGetLastError()
SIGNATURES = {
    "qb3_pack_groups": [_P, _P, _I64, _I64, _I32, _I64, _P, _P, _P, _P, _I64, _I64, _P],
    "qb3_extract_windows": [_P, _I64, _P, _I32, _I32, _P, _P],
    "qb3_chunkwalk": [_P, _I64, _P, _P, _I32, _P, _P, _I64, _I32, _I32, _I32,
                      _I32, _P, _P],
    "qb3_wavefront8": [_P, _I64, _I32, _P, _P, _P, _P, _P, _P],
    "qb3_wavefront_wide": [_P, _I64, _I32, _I32, _P, _P, _P, _P, _P, _P],
    "qb3_wavefront_fused": [_P, _I64, _P, _I64, _I32, _I32, _I32, _I32, _I64, _I32,
                            _P, _P, _P, _P, _P, _P, _P],
    "qb3_encode_pack_image": [_P, _P, _P, _P, _P, _P, _I64, _I32, _I32, _U64, _I64, _P, _P,
                              _P, _P, _I64, _I64, _P],
    "qb3_gather_slabs": [_P, _I64, _P, _I64, _I32, _I32, _P, _P],
    "qb3_place_slabs": [_P, _P, _I64, _I32, _P, _I64, _P],
    "qb3_place_parts": [_P, _I64, _P, _I64, _P],
    "qb3_probe_dim0_dot": [_P, _P, _I32, _I32, _I32, _P, _P],
    "qb3_probe_dma_1d": [_P, _I64, _P, _I32, _I32, _P, _P],
    "qb3_probe_flatten": [_P, _I32, _I32, _P, _P],
    "qb3_probe_dma_3d": [_P, _I32, _I32, _I32, _P, _I32, _P, _P],
    "qb3_probe_lane_write": [_P, _I32, _I32, _I32, _I32, _P, _P],
    "qb3_probe_lane_concat": [_P, _I32, _I32, _I32, _P, _P],
    "qb3_phase_a_fast": [_P, _P, _P, _I32, _P, _I64, _I32, _I32, _I32, _I32, _U64, _I32, _P,
                         _P, _P, _P, _P, _P],
    "qb3_phase_a_best": [_P, _P, _P, _I32, _P, _P, _I64, _I32, _I32, _I32, _I32, _U64, _P, _P,
                         _P, _P, _P, _P, _P, _P, _P, _P, _I64, _P],
    "qb3_quantize": [_P, _I64, _I32, _I32, _U64, _I32, _P, _P],
    "qb3_empty": [_P],
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


def read_sources(paths: list[str]) -> dict[str, bytes]:
    """File name -> contents of each path."""
    out = {}
    for path in paths:
        with open(path, "rb") as f:
            out[os.path.basename(path)] = f.read()
    return out


def lib_path(stem: str, flags: list[str], sources: dict[str, bytes]) -> str:
    """build/qb3_tpu_torch/lib<stem>_<hash>.so, the hash taken over the
    compiler flags and the sources (file name -> contents)."""
    h = hashlib.sha256(" ".join(flags).encode())
    for name, text in sources.items():
        h.update(name.encode() + text)
    return os.path.join(BUILD_DIR, f"lib{stem}_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile csrc/*.cu unless a library for these sources exists; returns
    its path.  Each source compiles in its own nvcc process, all at once,
    then one link.  The compilers' report (ptxas registers and spills) is
    kept beside the library as <library>.log."""
    sources = sorted(glob.glob(os.path.join(SRC_DIR, "*.cu")))
    lib = lib_path("qb3_tpu_torch", NVCC_FLAGS,
                   read_sources(sorted(glob.glob(os.path.join(SRC_DIR, "*.cu*")))))
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.{threading.get_ident()}.tmp"
    objs = [f"{tmp}.{os.path.basename(s)}.o" for s in sources]
    procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", o, s],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for s, o in zip(sources, objs)]
    steps = [(p.args, p.communicate()[0], p.returncode) for p in procs]
    if all(rc == 0 for _, _, rc in steps):
        link = subprocess.run([_nvcc(), *NVCC_FLAGS, "-shared", "-o", tmp, *objs],
                              capture_output=True, text=True)
        steps.append((link.args, link.stdout + link.stderr, link.returncode))
    for o in objs:
        if os.path.exists(o):
            os.remove(o)
    report = "".join(f"$ {' '.join(args)}\n{out}" for args, out, _ in steps)
    with open(lib + ".log", "w") as f:
        f.write(report)
    if any(rc != 0 for _, _, rc in steps):
        raise RuntimeError(f"nvcc failed:\n{report}")
    os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
    return lib


_LOCK = threading.Lock()  # one build and one load, whichever thread comes first
_LIB = None


def load() -> ctypes.PyDLL:
    """The kernel library, built on first call, with every entry point's
    argument types set.  Loaded as a PyDLL, whose calls keep the GIL: an
    entry point only enqueues a launch, and releasing and taking back the
    GIL would add to every launch's host time.  Safe to call from several
    threads at once (the shards of parallel/sharded.py): the first builds
    and loads under a lock, the others wait for it."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.PyDLL(build())
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIB = lib
        return _LIB


class Kernel:
    """One C entry point of the library, bound at its first call (which
    builds the library) and kept, so a launch costs one ctypes call: it
    passes the arguments on and raises if the entry point reports a CUDA
    error."""

    __slots__ = ("name", "fn")

    def __init__(self, name: str):
        self.name, self.fn = name, None

    def __call__(self, *args) -> None:
        if self.fn is None:
            self.fn = getattr(load(), self.name)
        err = self.fn(*args)
        if err:
            raise RuntimeError(f"{self.name}: CUDA error {err}")
