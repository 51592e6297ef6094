"""PNG read/write with full 16-bit support for the CLI.

The reference CLI converts 16-bit rasters through libicd with an endian
swap (cqb3.cpp:334-339).  Here Pillow covers the common cases (8-bit
anything, 16-bit grayscale); 16-bit multichannel PNGs — which Pillow would
silently truncate to 8 bits — go through a small pure-numpy codec
(IHDR/PLTE/IDAT parse, zlib, scanline unfilter).  Writing always targets
the minimal valid form: filter-0 scanlines, big-endian 16-bit samples.

A copy of qb3_tpu/pngio.py (which needs no JAX), so that the PyTorch
port's CLI never imports the JAX package.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _ihdr(data: bytes):
    if data[:8] != _SIG or data[12:16] != b"IHDR":
        raise ValueError("not a PNG")
    w, h, depth, ctype, comp, filt, ilace = struct.unpack(
        ">IIBBBBB", data[16:29])
    return w, h, depth, ctype, ilace


def probe(data: bytes):
    """(width, height, bitdepth, channels) from the header only."""
    w, h, depth, ctype, _ = _ihdr(data)
    return w, h, depth, _CHANNELS[ctype]


def read_png(path: str) -> np.ndarray:
    """-> (H, W, C) uint8 or uint16 array."""
    with open(path, "rb") as f:
        data = f.read()
    w, h, depth, ctype, ilace = _ihdr(data)
    if depth == 16 and ctype in (2, 4, 6):
        return _read_pure(data)  # Pillow would quietly drop to 8 bits
    from PIL import Image
    import io

    im = Image.open(io.BytesIO(data))
    arr = np.asarray(im)
    if arr.dtype == np.int32:  # mode "I" 16-bit grayscale
        arr = arr.astype(np.uint16)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr


def _read_pure(data: bytes) -> np.ndarray:
    w, h, depth, ctype, ilace = _ihdr(data)
    if ilace:
        raise ValueError("interlaced PNG not supported")
    nch = _CHANNELS[ctype]
    idat = bytearray()
    pos = 8
    while pos < len(data):
        (ln,) = struct.unpack(">I", data[pos : pos + 4])
        sig = data[pos + 4 : pos + 8]
        if sig == b"IDAT":
            idat += data[pos + 8 : pos + 8 + ln]
        pos += 12 + ln
    raw = zlib.decompress(bytes(idat))
    sbytes = depth // 8
    bpp = nch * sbytes
    stride = w * bpp
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    ftypes = rows[:, 0]
    cur = rows[:, 1:].astype(np.int32)
    out = np.zeros((h, stride), np.int32)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        f = ftypes[y]
        line = cur[y]
        if f == 0:
            line = line.copy()
        elif f == 2:  # up
            line = (line + prev) & 0xFF
        else:  # sub/average/paeth: left-recurrence, walk pixel columns
            line = line.copy()
            for x in range(0, stride, bpp):
                a = line[x - bpp : x] if x else np.zeros(bpp, np.int32)
                b = prev[x : x + bpp]
                c = prev[x - bpp : x] if x else np.zeros(bpp, np.int32)
                if f == 1:
                    pred = a
                elif f == 3:
                    pred = (a + b) >> 1
                else:  # paeth
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = np.where((pa <= pb) & (pa <= pc), a,
                                    np.where(pb <= pc, b, c))
                line[x : x + bpp] = (line[x : x + bpp] + pred) & 0xFF
        out[y] = line
        prev = line
    ob = out.astype(np.uint8).reshape(h, stride)
    if depth == 16:
        arr = ob.reshape(h, w, nch, 2)
        arr = (arr[..., 0].astype(np.uint16) << 8) | arr[..., 1]
    else:
        arr = ob.reshape(h, w, nch)
    if ctype == 3:  # palette
        plte_at = data.find(b"PLTE")
        (ln,) = struct.unpack(">I", data[plte_at - 4 : plte_at])
        pal = np.frombuffer(data[plte_at + 4 : plte_at + 4 + ln],
                            np.uint8).reshape(-1, 3)
        arr = pal[arr[:, :, 0]]
    return arr


def write_png(path: str, arr: np.ndarray):
    """(H, W[, C]) uint8/uint16 -> non-interlaced filter-0 PNG."""
    if arr.ndim == 2:
        arr = arr[:, :, None]
    h, w, nch = arr.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[nch]
    depth = 16 if arr.dtype == np.uint16 else 8
    if arr.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"unsupported dtype {arr.dtype}")
    if depth == 16:
        body = arr.astype(">u2").tobytes()
    else:
        body = arr.tobytes()
    stride = w * nch * (depth // 8)
    raw = bytearray()
    for y in range(h):
        raw += b"\x00" + body[y * stride : (y + 1) * stride]

    def chunk(sig, payload):
        return (struct.pack(">I", len(payload)) + sig + payload
                + struct.pack(">I", zlib.crc32(sig + payload)))

    out = bytearray(_SIG)
    out += chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0))
    out += chunk(b"IDAT", zlib.compress(bytes(raw), 6))
    out += chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(bytes(out))
