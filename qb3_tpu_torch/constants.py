"""Core constants of the QB3 stream format.

A copy of qb3_tpu/constants.py (which needs no JAX), so that the PyTorch
port never imports the JAX package.  They mirror the format-level definitions
of the reference implementation (QB3lib/QB3common.h:35-36, :185, :193 and
QB3lib/QB3.h:34-83), re-declared from the format spec (doc/QB3.md).
"""

from __future__ import annotations

import enum

# Microblock geometry: 4x4 pixels, 16 values per group (QB3common.h:35-36)
B = 4
B2 = B * B

# Maximum bands accepted by the reference encoder (QB3.h:34).  This engine
# extends the cap to 256 (the container band-count byte's full range, which
# the reference's own reader parses, QB3decode.cpp:139): hyperspectral
# streams with 17..256 bands are a documented compat divergence — the
# reference encoder refuses to produce them and its decoder rejects them at
# qb3_read_start, but they are well-formed under the stream grammar.
QB3_MAXBANDS = 16
QB3_MAXBANDS_EXT = 256

# Scan curves: 16 nibbles, each (y << 2 | x), MSB nibble first (QB3common.h:185,:193)
ZCURVE = 0x0145236789CDABEF
HILBERT = 0x01548CD9AEFB7623


class DType(enum.IntEnum):
    """qb3_dtype (QB3.h:40)."""

    U8 = 0
    I8 = 1
    U16 = 2
    I16 = 3
    U32 = 4
    I32 = 5
    U64 = 6
    I64 = 7


# Bytes per value, indexed by DType (QB3decode.cpp:25)
TYPESIZES = (1, 1, 2, 2, 4, 4, 8, 8)


class Mode(enum.IntEnum):
    """qb3_mode (QB3.h:50-74)."""

    BASE_Z = 0  # legacy z-curve base
    CF = 1  # z-curve + common factor
    RLE = 2  # z-curve + RLE
    CF_RLE = 3  # z-curve + CF + RLE
    BASE_H = 4  # Hilbert base  (alias QB3M_BASE)
    CF_H = 5  # Hilbert + CF
    RLE_H = 6  # Hilbert + RLE
    CF_RLE_H = 7  # Hilbert + CF + RLE  (alias QB3M_BEST)
    FTL = 8  # fastest, Hilbert base minus step encoding (alias QB3M_DEFAULT)
    END = 9  # end of settable modes
    STORED = 255  # raw bypass, cannot be requested


MODE_BASE = Mode.BASE_H
MODE_BEST = Mode.CF_RLE_H
MODE_DEFAULT = Mode.FTL


class Error(enum.IntEnum):
    """qb3_error (QB3.h:77-83)."""

    OK = 0
    EINV = 1
    UNKN = 2
    ERR = 3
    LIBERR = 255


def ubits_for(tsize: int) -> int:
    """Codeswitch unit width per type size in bytes (QB3encode.h:380)."""
    return {1: 3, 2: 4, 4: 5, 8: 6}[tsize]


def is_fast_mode(mode: int) -> bool:
    """Modes handled by the fast (non-best) encoder (QB3encode.cpp:340-342)."""
    return mode in (Mode.BASE_H, Mode.BASE_Z, Mode.FTL)


def needs_rle(mode: int) -> bool:
    """Modes with the RLE0 byte post-pass (QB3decode.cpp:309-312)."""
    return mode in (Mode.RLE, Mode.RLE_H, Mode.CF_RLE, Mode.CF_RLE_H)


def is_best_mode(mode: int) -> bool:
    """Modes using the best encoder (CF + index trials)."""
    return mode in (Mode.CF, Mode.CF_RLE, Mode.CF_H, Mode.CF_RLE_H)


def mode_uses_zcurve(mode: int) -> bool:
    """Legacy modes that imply the z-curve scan order (QB3encode.cpp:124-132)."""
    return mode in (Mode.BASE_Z, Mode.CF, Mode.CF_RLE, Mode.RLE)


def curve_offsets(order: int):
    """Decode a 64-bit curve into 16 (dy, dx) pairs, MSB nibble first.

    Matches the offset construction of the reference scan loops
    (QB3encode.h:404-407).
    """
    out = []
    for i in range(B2):
        n = (order >> ((B2 - 1 - i) << 2)) & 0xF
        out.append(((n >> 2) & 0b11, n & 0b11))
    return out
