"""The serial walk in C++: ctypes bindings of native/qb3xs.cpp's qb3xs_parse.

Counterpart of qb3_tpu/native.py, which runs make inside native/.  The port
compiles the same source with g++ into build/qb3_tpu_torch/ beside the
package, named by a hash of the sources and flags as _build.py names the
CUDA library; it reads the tracked native/qb3xs_tables.inc as it is and
writes nothing into native/.  Nothing is compiled at import time: load()
builds at first use and returns None where there is no compiler or no
source, and the caller then takes the Python walk (offsets.py).
"""

from __future__ import annotations

import ctypes as ct
import functools
import os
import subprocess

import numpy as np

from . import _build

NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "native")
SOURCE = os.path.join(NATIVE_DIR, "qb3xs.cpp")
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]


def build() -> str:
    """Compile native/qb3xs.cpp unless a library for this source exists;
    returns its path."""
    lib = _build.lib_path("qb3xs", CXX_FLAGS,
                          [SOURCE, os.path.join(NATIVE_DIR, "qb3xs_tables.inc")])
    if os.path.exists(lib):
        return lib
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    run = subprocess.run([os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", tmp, SOURCE],
                         capture_output=True, text=True, timeout=300)
    if run.returncode != 0:
        raise RuntimeError(f"g++ failed:\n{run.stdout}{run.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
    return lib


@functools.cache
def load():
    """The walk library, built on first call; None if it cannot be built."""
    try:
        lib = ct.CDLL(build())
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return None
    lib.qb3xs_parse.restype = ct.c_int64
    lib.qb3xs_parse.argtypes = [
        ct.c_void_p, ct.c_size_t, ct.c_int64, ct.c_int, ct.c_int, ct.c_int,
        ct.c_void_p, ct.c_void_p, ct.c_void_p, ct.c_void_p, ct.c_void_p,
        ct.c_void_p, ct.c_void_p, ct.c_int64]
    return lib


def available() -> bool:
    return load() is not None


def parse_offsets_native(payload: bytes, nblocks: int, nbands: int, tsize: int,
                         is_ftl: bool, entry_runbits=None, entry_cf=None,
                         start_bit: int = 0):
    """offsets.parse_offsets in C++, without its pcf_in / block_start /
    exit state; end_pos is 0 after a failed walk."""
    n = nblocks * nbands
    kind = np.zeros(n, np.uint8)
    val_pos = np.zeros(n, np.int64)
    vrung = np.zeros(n, np.int32)
    cf = np.zeros(n, np.uint64)
    rung = np.zeros(n, np.int32)
    buf = np.frombuffer(payload + b"\x00" * 16, np.uint8)  # padded peek window
    erb = np.asarray(entry_runbits, np.int32) if entry_runbits is not None else None
    ecf = np.asarray(entry_cf, np.uint64) if entry_cf is not None else None
    end = load().qb3xs_parse(
        buf.ctypes.data, len(payload), nblocks, nbands, tsize, int(is_ftl),
        erb.ctypes.data if erb is not None else None,
        ecf.ctypes.data if ecf is not None else None,
        kind.ctypes.data, val_pos.ctypes.data, vrung.ctypes.data,
        cf.ctypes.data, rung.ctypes.data, start_bit)
    failed = end < 0  # -(failed_group + 1); remaining kinds already zeroed
    shape = (nblocks, nbands)
    return dict(kind=kind.reshape(shape), val_pos=val_pos.reshape(shape),
                vrung=vrung.reshape(shape), cf=cf.reshape(shape),
                rung=rung.reshape(shape), end_pos=0 if failed else int(end),
                failed=failed, failed_group=int(-end - 1) if failed else -1)
