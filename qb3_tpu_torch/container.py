"""QB3 v2 container: main header + chunk headers (host side).

Byte layout per doc/QB3.md:223-263 and QB3encode.cpp:194-268:

  main header (11 bytes): "QB3\x80", xsize-1 (u16le), ysize-1 (u16le),
      nbands-1 (u8), dtype (u8), mode (u8)
  chunks, byte aligned, ended by the data chunk:
      "CB" u16le(nbands) + nbands bytes      core-band mapping (if any)
      "QV" u16le(n in 1..4) + n bytes        quantization value (if >= 2)
      "SC" u16le(8) + u64le                  scan curve (if not legacy z-curve)
      "DT"                                   start of entropy-coded payload
  unknown chunks: skippable iff the first signature letter is lowercase
  (QB3decode.cpp:251-259) — our optional block-length index uses "ix".
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

from .constants import HILBERT, ZCURVE, Mode
from .errors import QB3HeaderError


def topbit_int(v: int) -> int:
    return v.bit_length() - 1


def write_headers(xsize: int, ysize: int, nbands: int, dtype: int, mode: int,
                  cband, quanta: int, order: int, index: bytes | None = None,
                  index_sig: bytes = b"ix") -> bytes:
    out = bytearray()
    out += b"QB3\x80"
    out += struct.pack("<HHBBB", xsize - 1, ysize - 1, nbands - 1, dtype, mode & 0xFF)
    if mode != Mode.STORED and any(cband[c] != c for c in range(nbands)):
        out += b"CB" + struct.pack("<H", nbands) + bytes(cband[:nbands])
    if quanta >= 2:
        qbytes = 1 + topbit_int(quanta) // 8
        out += b"QV" + struct.pack("<H", qbytes) + quanta.to_bytes(qbytes, "little")
    if order != ZCURVE and mode != Mode.STORED:
        out += b"SC" + struct.pack("<H", 8) + struct.pack("<Q", order or HILBERT)
    if index:
        # "ix"/"ib": our skippable sidecars (lowercase first letter => older
        # readers ignore them, QB3decode.cpp:251-259).  "ix": per-group bit
        # lengths u16le (fast modes); "ib": lengths + decode metadata (best
        # modes).  NB the reference skips `len` bytes from the chunk *start*
        # (QB3decode.cpp:254-255), so the len field counts the 4 header bytes.
        for pos in range(0, len(index), 65530):
            chunk = index[pos : pos + 65530]
            out += index_sig + struct.pack("<H", len(chunk) + 4) + chunk
    out += b"DT"
    return bytes(out)


@dataclass
class StreamInfo:
    xsize: int
    ysize: int
    nbands: int
    dtype: int
    mode: int
    quanta: int = 1
    order: int = 0
    cband: list = field(default_factory=list)
    data_offset: int = 0  # byte offset of the DT payload
    index: bytes | None = None  # optional "ix" block-length sidecar
    index_best: bytes | None = None  # optional "ib" best-mode decode sidecar
    index_chunked: bytes | None = None  # optional "ic" chunk-anchor sidecar


def parse_headers(stream: bytes) -> StreamInfo:
    """3-stage reader collapsed to one host parse (QB3decode.cpp:130-264)."""
    if len(stream) < 11 + 4 or stream[:4] != b"QB3\x80":
        raise QB3HeaderError("not a QB3 stream")
    xm, ym, bm, dt, mode = struct.unpack("<HHBBB", stream[4:11])
    info = StreamInfo(xsize=xm + 1, ysize=ym + 1, nbands=bm + 1, dtype=dt, mode=mode)
    if info.nbands > 256 or dt > 7:
        raise QB3HeaderError("invalid header")
    if mode >= Mode.END and mode != Mode.STORED:
        raise QB3HeaderError("invalid mode")
    if mode in (Mode.BASE_Z, Mode.CF, Mode.CF_RLE, Mode.RLE):
        info.order = ZCURVE
    info.cband = list(range(info.nbands))
    pos = 11
    index = bytearray()
    index_best = bytearray()
    index_chunked = bytearray()
    while True:
        if pos + 2 > len(stream):
            raise QB3HeaderError("truncated headers")
        sig = stream[pos : pos + 2]
        if sig == b"DT":
            info.data_offset = pos + 2
            break
        if pos + 4 > len(stream):
            raise QB3HeaderError("truncated chunk")
        (ln,) = struct.unpack("<H", stream[pos + 2 : pos + 4])
        body = stream[pos + 4 : pos + 4 + ln]
        if sig == b"QV":
            if not 1 <= ln <= 4 or len(body) != ln:
                raise QB3HeaderError("bad QV chunk")
            info.quanta = int.from_bytes(body, "little")
            if info.quanta < 2:
                raise QB3HeaderError("bad quanta")
        elif sig == b"CB":
            if ln != info.nbands:
                raise QB3HeaderError("bad CB chunk")
            info.cband = list(body)
            if any(c >= info.nbands for c in info.cband):
                raise QB3HeaderError("bad core band")
        elif sig == b"SC":
            if ln != 8:
                raise QB3HeaderError("bad SC chunk")
            info.order = struct.unpack("<Q", body)[0]
            if not _check_curve(info.order):
                raise QB3HeaderError("bad curve")
        elif sig in (b"ix", b"ib", b"ic"):
            # len counts from the chunk start (see write_headers)
            if sig == b"ix":
                index += stream[pos + 4 : pos + ln]
            elif sig == b"ib":
                index_best += stream[pos + 4 : pos + ln]
            else:
                index_chunked += stream[pos + 4 : pos + ln]
            pos += ln
            continue
        elif sig[0] & 0x20:
            pos += ln  # skippable: len counts from the chunk start
            continue
        else:
            raise QB3HeaderError(f"unknown chunk {sig!r}")
        pos += 4 + ln
    if index:
        info.index = bytes(index)
    if index_best:
        info.index_best = bytes(index_best)
    if index_chunked:
        info.index_chunked = bytes(index_chunked)
    return info


def _check_curve(val: int) -> bool:
    """All 16 nibble values must be present (QB3decode.cpp:117-125)."""
    mask = 0
    for _ in range(16):
        mask |= 1 << (val & 0xF)
        val >>= 4
    return mask == 0xFFFF
