"""Streaming strips: bounded-memory encode and decode of arbitrarily tall
rasters, byte-exact with the whole-image encoder.  Counterpart of
qb3_tpu/strip.py.

    se = StripEncoder(width, height, bands, DType.U8, mode=Mode.FTL)
    for rows in row_chunks:          # any heights, in order
        se.push(rows)
    stream = se.finish()             # == Encoder(...).encode(whole_image)

    sd = StripDecoder(stream)
    while (rows := sd.read(64)) is not None:
        consume(rows)                # rows arrive in order, dequantized

The band state (prev value, rung history, previous CF) persists across
strips, as in the reference's strip-wise sub-encoding of quantized images
(QB3encode.cpp:405-455).  Each strip goes to the device at its native
width and encodes there through the port's encode (at a step of 2 or more
K11 quantizes it first; phase A + K1, the best modes' phase A + K1, or the
image-layout phase A + K8 where api.takes_fused says so); its words stay on
the device, trimmed to the strip's bit total, and finish() stitches them
once with K6 (stitch.stitch_words_device) and copies the stream to the host
once, where qb3_tpu copies every strip to the host and stitches there.  The
stored-raw fallback for incompressible images is not available in streaming
mode (the raster is gone by finish()); quanta, the RLE0 post-pass, core
bands, scan order and the sidecars match qb3_tpu's StripEncoder: "ix" and
"ic" in the fast modes, "ib" in the best modes (for index True or "ic"),
assembled from the strips' decode metadata; framing.py frames the stream.
The decoder walks the stream strip by strip on the host (the C++ walk, or
the Python one), carrying the per-band previous CF, and decodes each strip
with K7 + K5 and reconstruct on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from . import container, framing, profiling, rle
from .api import (NP_FROM_DT, Decoder, Encoder, dequantize, from_carrier, group_inputs,
                  padded_words, walk_offsets)
from .constants import B, B2, HILBERT, DType, Mode, needs_rle
from .offsets import KIND_CF, KIND_CF0
from .errors import QB3DataError, QB3ShapeError
from .ops.bitpack import words_to_bytes
from .ops.decode import decode_groups, reconstruct
from .ops.decode_chunked import IC_DEFAULT_K
from .stitch import stitch_words_device

class StripEncoder:
    def __init__(self, width: int, height: int, bands: int, dtype: DType,
                 mode: int = Mode.FTL, quanta: int = 1, away: bool = False,
                 coreband=None, strip_rows: int = 64, with_index=False,
                 index_chunk_blocks: int = 0, device="cuda"):
        if width < B or height < B:
            raise QB3ShapeError("streaming encode needs width, height >= 4")
        if strip_rows % B:
            raise QB3ShapeError("strip_rows must be a multiple of 4")
        # the Encoder validates and holds the persistent band state
        self._enc = Encoder(width, height, bands, dtype, device)
        self._enc.set_mode(mode)
        if quanta != 1 and not self._enc.set_quanta(quanta, away):
            raise QB3ShapeError(f"invalid quanta {quanta}")
        if coreband is not None:
            self._enc.set_coreband(coreband)
        self.user_mode = self._enc.mode
        self.mode = framing.RLE_BASE.get(self.user_mode, self.user_mode)
        self.strip_rows = strip_rows
        self.with_index = with_index
        self.index_chunk_blocks = index_chunk_blocks
        self._np_dt = NP_FROM_DT[self._enc.dtype]
        self._pending = np.zeros((0, width, bands), self._np_dt)
        self._row0 = 0          # absolute row index of _pending[0]
        self._frontier = 0      # next absolute row to encode (B-aligned)
        self._rows_seen = 0
        self._parts = []        # each strip's words on the device, trimmed to its total
        self._totals = []       # each strip's bits
        self._pieces = []       # each strip's sidecar pieces (framing.sidecar), on the host
        self._done = False

    # ------------------------------------------------------------------ feed

    def push(self, rows: np.ndarray):
        """Append (h, width, bands) rows; encodes completed block rows."""
        e = self._enc
        rows = np.asarray(rows).reshape(-1, e.xsize, e.nbands)
        if rows.dtype != np.dtype(self._np_dt):
            raise QB3ShapeError(f"dtype mismatch: {rows.dtype}")
        if self._rows_seen + rows.shape[0] > e.ysize:
            raise QB3ShapeError("more rows than the declared height")
        with profiling.span("strip.push"):
            self._pending = np.concatenate([self._pending, rows], axis=0)
            self._rows_seen += rows.shape[0]
            self._drain(flush=self._rows_seen == e.ysize)

    def _drain(self, flush: bool = False):
        """Encode aligned strips as their rows become available.

        Without flush, only whole strip_rows chunks encode (stable kernel
        shapes); flush encodes everything up to the last aligned block row.
        """
        e = self._enc
        aligned_end = (e.ysize // B) * B
        while True:
            avail_end = self._row0 + self._pending.shape[0]
            take = min(avail_end, aligned_end) - self._frontier
            if not flush:
                take -= take % self.strip_rows
            if take <= 0:
                break
            i0 = self._frontier - self._row0
            self._encode_strip(self._pending[i0 : i0 + take])
            self._frontier += take
            keep_abs = self._frontier
            if e.ysize % B:  # the shifted tail block row re-reads these rows
                keep_abs = min(keep_abs, e.ysize - B)
            drop = max(0, keep_abs - self._row0)
            self._pending = self._pending[drop:]
            self._row0 += drop

    def _encode_strip(self, strip: np.ndarray):
        e = self._enc
        with profiling.span("strip.encode", device=e.device):
            x = e._carrier(strip, "strip.quantize")
            used, total, state, glen, rung, best = e._encode_words(x, self.mode)
            e._commit_state(state)
            self._parts.append(used.clone())  # the copy frees the worst-case buffer
        self._totals.append(total)
        profiling.count("strip.strips")
        if self.with_index:
            pieces = dict(glen=glen, rung=rung) if best is None else \
                dict(glen=glen, meta16=best[0], cfv=best[1])
            self._pieces.append({k: v.cpu().numpy() for k, v in pieces.items()})

    # ---------------------------------------------------------------- finish

    def finish(self) -> bytes:
        e = self._enc
        if self._done:
            raise QB3ShapeError("finish() called twice")
        if self._rows_seen != e.ysize:
            raise QB3ShapeError(
                f"got {self._rows_seen} rows, declared {e.ysize}")
        with profiling.span("strip.finish"):
            stream = self._finish()
        profiling.count("strip.scenes")
        return stream

    def _finish(self) -> bytes:
        e = self._enc
        self._drain(flush=True)
        if e.ysize % B:  # final shifted block row (QB3encode.h:409-416)
            i0 = (e.ysize - B) - self._row0
            self._encode_strip(self._pending[i0 : i0 + B])
        self._done = True
        total = sum(self._totals)
        with profiling.span("strip.stitch", device=e.device):
            words, total = stitch_words_device(self._parts, self._totals, (total + 31) // 32)
        self._parts = []
        with profiling.span("strip.bytes"):
            payload = words_to_bytes(words.cpu().numpy().view(np.uint32), total)

        pieces = {k: np.concatenate([p[k] for p in self._pieces]) for k in self._pieces[0]} \
            if self._pieces else {}
        side = framing.sidecar(self.with_index, **pieces,
                               k=self.index_chunk_blocks or IC_DEFAULT_K)
        # raw=None: no stored fallback, the raster is gone (qb3_tpu/strip.py:16-19)
        return e._frame().finish(self.user_mode, payload, side, e.max_encoded_size(), raw=None)


class StripDecoder:
    """Bounded-memory streaming decode, the read-side mirror of StripEncoder
    (no reference equivalent: QB3decode.cpp decodes whole images).  The
    stream is walked strip by strip with carried band state (bit cursor,
    per-band rung history, previous CF, running prev values); memory is
    O(width x strip_rows x bands) plus the compressed payload, whose words
    go to the device once.  `decode_path` records the walk of the last strip
    ("native-walk" or "python-walk"), or the whole decode's path for the
    stored and tiny streams, which decode whole.

        sd = StripDecoder(stream)
        while (rows := sd.read(64)) is not None:
            consume(rows)        # rows arrive in order, dequantized
    """

    def __init__(self, stream: bytes, strip_rows: int = 64, device="cuda"):
        if strip_rows % B:
            raise QB3ShapeError("strip_rows must be a multiple of 4")
        self.info = info = container.parse_headers(stream)
        self.device = torch.device(device)
        self.strip_rows = strip_rows
        self.decode_path = None
        self._np_dt = NP_FROM_DT[DType(info.dtype)]
        self._tsize = np.dtype(self._np_dt).itemsize
        h, w = info.ysize, info.xsize
        self._row = 0
        self._whole = None
        if w < B or h < B or info.mode == Mode.STORED:  # tiny/stored: nothing to stream
            dec = Decoder(stream, device)
            self._whole = dec.read_data()
            self.decode_path = dec.decode_path
            return
        data = stream[info.data_offset:]
        if needs_rle(info.mode):
            expected = rle.rle0_decoded_size(data)
            if expected > h * w * info.nbands * self._tsize:
                raise QB3DataError("RLE expansion exceeds image size")
            data = rle.rle0_decode(data, expected)
        self._data = data
        self._words32 = torch.from_numpy(padded_words(data).view(np.int32)).to(self.device)
        # carried band state; the previous CF stays zero in the fast modes
        nb = info.nbands
        self._bit = 0
        self._runbits = np.zeros(nb, np.int32)
        self._pcf = np.zeros(nb, np.uint64)
        self._prev = torch.zeros(nb, dtype=torch.int64, device=self.device)
        self._pending = np.zeros((0, w, nb), self._np_dt)

    def read(self, n_rows: int | None = None):
        """Next <= n_rows rows (default strip_rows), or None at the end."""
        h = self.info.ysize
        want = min(n_rows or self.strip_rows, h - self._row)
        if want <= 0:
            return None
        if self._whole is not None:
            out = self._whole[self._row : self._row + want]
            self._row += want
            return out
        while self._pending.shape[0] < want and self._decoded_until() < h:
            self._decode_next_strip()
        out = self._pending[:want]
        self._pending = self._pending[want:]
        self._row += out.shape[0]
        return out if out.shape[0] else None

    def _decoded_until(self) -> int:
        return self._row + self._pending.shape[0]

    def _decode_next_strip(self):
        info = self.info
        h, w, nb = info.ysize, info.xsize, info.nbands
        aligned_end = (h // B) * B
        # the shifted tail block row (h % B != 0) overwrites rows
        # [h-B, aligned_end): regular strips emit only rows < h-B, the tail
        # strip emits all of [h-B, h) — matching "later blocks win"
        tail_start = h - B if h % B else h
        at = self._decoded_until()
        if at < tail_start:
            hs = min(self.strip_rows, aligned_end - at)
            emit_count = min(hs, tail_start - at)
            last = at + hs >= h
        else:  # tail
            hs = B
            emit_count = B
            last = True
        nblocks = (hs // B) * (w // B)
        tbits = 8 * self._tsize
        meta, self.decode_path = walk_offsets(self._data, nblocks, nb, self._tsize, info.mode,
                                              self._runbits, self._pcf, self._bit)
        inp = group_inputs(meta, self._words32.shape[0], tbits, self.device)
        g = decode_groups(self._words32, **inp, tbits=tbits, apply_step=info.mode != Mode.FTL)
        img, exit_prev = reconstruct(g.reshape(nblocks, nb, B2), self._prev, hs, w, nb,
                                     info.order or HILBERT, tuple(info.cband), tbits)
        img = from_carrier(img, self._tsize)
        if meta["failed"]:
            raise QB3DataError(f"corrupt stream (group {meta['failed_group']})",
                               partial=img)
        # advance carried state
        self._bit = meta["end_pos"]
        self._runbits = meta["rung"].reshape(nblocks, nb)[-1].astype(np.int32)
        self._prev = exit_prev
        # each band's previous CF: its last CF / CF0 group's, biased
        kind, cf = meta["kind"].reshape(nblocks, nb), meta["cf"].reshape(nblocks, nb)
        iscf = (kind == KIND_CF) | (kind == KIND_CF0)
        for c in np.flatnonzero(iscf.any(0)):
            self._pcf[c] = cf[iscf[:, c], c][-1] - np.uint64(2)
        # end-of-stream rule on the final strip (QB3decode.h:411)
        if last:
            leftover = len(self._data) * 8 - meta["end_pos"]
            if leftover > 7:
                raise QB3DataError(f"{leftover} leftover bits", partial=img)
        out = img.view(self._np_dt)[:emit_count]
        if info.quanta > 1:
            out = dequantize(out, info.quanta)
        self._pending = np.concatenate([self._pending, out], axis=0)
