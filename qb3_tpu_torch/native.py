"""The host's serial pieces in C++: ctypes bindings of native/qb3xs.cpp's
qb3xs_parse (the stream walk) and qb3xs_rle0_encode / _decode / _size (the
RLE0 post-pass).

Counterpart of qb3_tpu/native.py, which runs make inside native/.  The port
compiles the same C++ source with g++ into build/qb3_tpu_torch/ beside the
package, named by a hash of the sources and flags as _build.py names the
CUDA library.  The decode tables the source includes are written from the
port's own tables.py (tables_inc), into a directory of this build's own, so
the build reads nothing that another process may be rewriting: make in
native/ regenerates native/qb3xs_tables.inc in place whenever that file
looks older than its generator.  Nothing is written into native/ and
nothing is compiled at import time: load() builds at first use and returns
None where there is no compiler, and the callers then take the Python
walk (offsets.py) and the Python RLE0 pass (rle.py).
"""

from __future__ import annotations

import ctypes as ct
import functools
import os
import shutil
import subprocess

import numpy as np

from . import _build, tables

NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "native")
SOURCE = os.path.join(NATIVE_DIR, "qb3xs.cpp")
TABLES_INC = "qb3xs_tables.inc"  # the name qb3xs.cpp includes
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]


def _emit_u16(name: str, arr) -> str:
    vals = ", ".join(str(int(v)) for v in arr)
    return f"static const uint16_t {name}[] = {{{vals}}};\n"


def _packed(tbl):
    """(N, 2) (len, val) -> len<<12 | val packed u16."""
    return (tbl[:, 0].astype(np.uint32) << 12) | tbl[:, 1].astype(np.uint32)


def tables_inc() -> str:
    """The text of native/qb3xs_tables.inc (the codeswitch and group decode
    tables), written from tables.py as tools/gen_tables_c.py writes it from
    qb3_tpu's tables."""
    parts = ["// generated by tools/gen_tables_c.py — do not edit\n"]
    for u in (3, 4, 5, 6):
        parts.append(_emit_u16(f"DSW{u}", _packed(tables.DSW[u, : 1 << (u + 1)])))
    for r in range(8):
        parts.append(_emit_u16(f"DGRP{r}", _packed(tables.DEC_GROUP[r, : 1 << (r + 2)])))
        parts.append(_emit_u16(f"DSGL{r}", _packed(tables.DEC_SINGLE[r, : 1 << (r + 2)])))
    parts.append(_emit_u16("IDXD", _packed(tables.IDX_DEC[:16])))
    parts.append("static const uint16_t* DSW_T[7] = {0,0,0,DSW3,DSW4,DSW5,DSW6};\n")
    parts.append("static const uint16_t* DGRP_T[8] = {"
                 + ",".join(f"DGRP{r}" for r in range(8)) + "};\n")
    parts.append("static const uint16_t* DSGL_T[8] = {"
                 + ",".join(f"DSGL{r}" for r in range(8)) + "};\n")
    return "".join(parts)


def build() -> str:
    """Compile native/qb3xs.cpp with the port's tables unless a library for
    these sources exists; returns its path."""
    sources = dict(_build.read_sources([SOURCE]), **{TABLES_INC: tables_inc().encode()})
    lib = _build.lib_path("qb3xs", CXX_FLAGS, sources)
    if os.path.exists(lib):
        return lib
    tmp = f"{lib}.{os.getpid()}.tmp"
    os.makedirs(tmp + ".d", exist_ok=True)
    try:
        for name, text in sources.items():
            with open(os.path.join(tmp + ".d", name), "wb") as f:
                f.write(text)
        run = subprocess.run([os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", tmp,
                              os.path.join(tmp + ".d", os.path.basename(SOURCE))],
                             capture_output=True, text=True, timeout=300)
        if run.returncode != 0:
            raise RuntimeError(f"g++ failed:\n{run.stdout}{run.stderr}")
        os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
    finally:
        shutil.rmtree(tmp + ".d", ignore_errors=True)
    return lib


@functools.cache
def load():
    """The library, built on first call; None if it cannot be built."""
    try:
        lib = ct.CDLL(build())
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return None
    lib.qb3xs_parse.restype = ct.c_int64
    lib.qb3xs_parse.argtypes = [
        ct.c_void_p, ct.c_size_t, ct.c_int64, ct.c_int, ct.c_int, ct.c_int,
        ct.c_void_p, ct.c_void_p, ct.c_void_p, ct.c_void_p, ct.c_void_p,
        ct.c_void_p, ct.c_void_p, ct.c_int64]
    lib.qb3xs_rle0_encode.restype = ct.c_int64
    lib.qb3xs_rle0_encode.argtypes = [ct.c_void_p, ct.c_int64, ct.c_void_p]
    lib.qb3xs_rle0_decode.restype = ct.c_int64
    lib.qb3xs_rle0_decode.argtypes = [ct.c_void_p, ct.c_int64, ct.c_void_p, ct.c_int64]
    lib.qb3xs_rle0_size.restype = ct.c_int64
    lib.qb3xs_rle0_size.argtypes = [ct.c_void_p, ct.c_int64]
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


def rle0_encode(data: bytes) -> bytes:
    src = np.frombuffer(data, np.uint8)
    # worst case expands 3/2 (every 0xff pair becomes a triple)
    dst = np.zeros(len(data) * 3 // 2 + 16, np.uint8)
    n = load().qb3xs_rle0_encode(src.ctypes.data, len(data), dst.ctypes.data)
    return dst[:n].tobytes()


def rle0_decode(data: bytes, expected: int) -> bytes:
    src = np.frombuffer(data, np.uint8)
    dst = np.zeros(expected, np.uint8)
    n = load().qb3xs_rle0_decode(src.ctypes.data, len(data), dst.ctypes.data, expected)
    if n < 0:
        raise ValueError("RLE0 length mismatch")
    return dst.tobytes()


def rle0_size(data: bytes) -> int:
    src = np.frombuffer(data, np.uint8)
    return int(load().qb3xs_rle0_size(src.ctypes.data, len(data)))
