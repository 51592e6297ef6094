"""RLE0 byte-level post-pass over the finished entropy stream.

Stream grammar (doc/QB3.md; QB3encode.cpp:271-332, QB3decode.cpp:267-307):
  ff ff ff      -> two literal 0xff bytes
  ff ff n(!=ff) -> a run of 4+n zero bytes (n in 0..0xfe)
Coding rules: a zero run is escaped only when at least 4 zeros follow and the
previously emitted byte was not a literal 0xff (that would glue into a fake
escape); the final two input bytes are always literal.

The implementations here are event-driven: candidate escape sites (>= 2
consecutive 0xff, >= 4 consecutive zeros) are located up front with
vectorized scans, literals between sites are copied in bulk, and only the
sites themselves run through the coding rules.

A copy of qb3_tpu/rle.py without its optional native C helper (the port loads
no host library); the helper implements the same algorithm, so the bytes are
the same.
"""

from __future__ import annotations

import numpy as np

_MAX_RUN = 258  # 4 implied zeros + a 0..0xfe extension count


def rle0_encode(data: bytes) -> bytes:
    n = len(data)
    if n < 3:
        return data
    buf = np.frombuffer(data, np.uint8)
    # candidate escape sites; both lists include every overlapping start, so
    # re-entering a partially consumed site is just "the next event"
    ffpair = np.flatnonzero((buf[:-1] == 0xFF) & (buf[1:] == 0xFF))
    zero4 = np.flatnonzero(
        (buf[:-3] == 0) & (buf[1:-2] == 0) & (buf[2:-1] == 0) & (buf[3:] == 0))
    if not len(ffpair) and not len(zero4):
        return data
    nz = np.flatnonzero(buf)  # for run-length queries
    events = np.union1d(ffpair, zero4)

    out = bytearray()
    pos = 0
    lit_ff = False  # last emitted byte was a literal 0xff
    body = n - 2  # escapes may only start before the final two bytes
    for e in events:
        e = int(e)
        if e < pos or e >= body:
            continue
        if e > pos:
            out += data[pos:e]
            lit_ff = buf[e - 1] == 0xFF
            pos = e
        if buf[pos]:  # 0xff pair site
            out += b"\xff\xff\xff"
            pos += 2
            lit_ff = False
        elif lit_ff:
            # a zero run shadowed by a preceding literal 0xff: one literal
            # zero unshadows it; the remainder re-enters via the next event
            out.append(0)
            pos += 1
            lit_ff = False
        else:
            k = nz[np.searchsorted(nz, pos)] - pos if nz.size and nz[-1] > pos else n - pos
            k = min(int(k), _MAX_RUN)
            out += bytes((0xFF, 0xFF, k - 4))
            pos += k
    out += data[pos:]
    return bytes(out)


def rle0_decode(data: bytes, expected: int) -> bytes:
    """Expand; raises on overflow past ``expected`` bytes (malicious input guard)."""
    n = len(data)
    buf = np.frombuffer(data, np.uint8)
    pairs = (np.flatnonzero((buf[:-1] == 0xFF) & (buf[1:] == 0xFF))
             if n > 1 else np.empty(0, np.int64))
    out = bytearray()
    pos = 0
    for e in pairs:
        e = int(e)
        if e < pos or e >= n - 2:
            continue
        out += data[pos:e]
        count, fill = (2, 0xFF) if buf[e + 2] == 0xFF else (4 + int(buf[e + 2]), 0)
        if len(out) + count > expected:
            raise ValueError("RLE0 output overflow")
        out += bytes((fill,)) * count
        pos = e + 3
    out += data[pos:]
    if len(out) != expected:
        raise ValueError("RLE0 length mismatch")
    return bytes(out)


def rle0_decoded_size(data: bytes) -> int:
    """Size after expansion (QB3decode.cpp:294-307)."""
    n = len(data)
    buf = np.frombuffer(data, np.uint8)
    pairs = (np.flatnonzero((buf[:-1] == 0xFF) & (buf[1:] == 0xFF))
             if n > 1 else np.empty(0, np.int64))
    total = 0
    pos = 0
    for e in pairs:
        e = int(e)
        if e < pos or e >= n - 2:
            continue
        total += (e - pos) + (2 if buf[e + 2] == 0xFF else 4 + int(buf[e + 2]))
        pos = e + 3
    return total + (n - pos)
