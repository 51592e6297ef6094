"""The framing of an encoded stream, for every encode entry: which sidecar
a stream carries, its header, and the finish of a whole stream (the RLE0
post-pass and the stored fallback of qb3_encode, QB3encode.cpp:488-574).

api.Encoder, strip.StripEncoder, batch.encode_finish and
parallel/sharded.encode_sharded frame through this module.  Where they
differ, qb3_tpu's entries differ the same way, and the call site says so:

  (a) only the one-shot Encoder tries the best modes' "ic" sidecar (it
      passes entry_cf to sidecar, qb3_tpu/api.py:346-352); the batch, the
      strips and the shards write "ib" for any true index;
  (b) StripEncoder has no stored fallback (raw=None, qb3_tpu/strip.py:16-19);
  (c) encode_sharded stores also after an RLE mode whose post-pass was not
      taken (store_rle=True, qb3_tpu/parallel/sharded.py:305-308), where the
      Encoder keeps the coded stream.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from . import container, profiling, rle
from .constants import Mode, needs_rle
from .offsets import KIND_CF, KIND_CF0
from .ops.decode_chunked import (IC_DEFAULT_K, chunk_spans, chunk_spans_best, pack_ic,
                                 pack_ic_best)

# the mode an RLE form encodes in before its RLE0 post-pass
RLE_BASE = {Mode.RLE: Mode.BASE_Z, Mode.CF_RLE: Mode.CF,
            Mode.RLE_H: Mode.BASE_H, Mode.CF_RLE_H: Mode.CF_H}


def best_sidecar(glens: np.ndarray, meta16: np.ndarray, cfv: np.ndarray) -> bytes | None:
    """The "ib" sidecar: per group a u16 bit length and a u16 meta (kind |
    vrung << 3 | prefix_len << 9), then a u16 biased CF (cf - 2) for each CF
    / CF0 group, little-endian in group order; None when a CF passes 16 bits
    (the decoder then walks the stream)."""
    kind = meta16 & 7
    cfm = cfv[(kind == KIND_CF) | (kind == KIND_CF0)]
    if cfm.size and int(cfm.max()) > 0xFFFF:
        return None
    return (glens.astype("<u2").tobytes() + meta16.astype("<u2").tobytes()
            + cfm.astype("<u2").tobytes())


def _fits(spans: np.ndarray) -> bool:
    """Whether the "ic" spans stay inside the device walk's int32 bit cursors."""
    return int(spans.sum()) < 1 << 31


def sidecar(index, glen=None, rung=None, entry_runbits=0, k: int = IC_DEFAULT_K, *,
            spans=None, entry=None, meta16=None, cfv=None, pcf_in=None, entry_cf=None):
    """The sidecar of one stream -> (bytes or None, its signature).

    index: the kind asked for (False, True / "ix", or "ic"); glen: the
    groups' bit lengths in stream order.  The fast modes' "ic" takes its
    chunk spans and entry rungs, or the rungs after each block (nblocks,
    nbands) and the entry runbits to compute them from, in chunks of k
    blocks.  The best modes give meta16 and cfv and write "ib" for any true
    index; with pcf_in (the biased CF before each block) and entry_cf too,
    "ic" tries the best modes' "ic" first.  Cut-offs: no "ic" past 2^31
    bits of spans, no best "ic" past a 16-bit pcf, no "ib" past a 16-bit
    CF."""
    if not index:
        return None, b"ix"
    if meta16 is not None:
        if index == "ic" and entry_cf is not None:
            pieces = chunk_spans_best(glen.astype(np.int64), rung, pcf_in, entry_runbits,
                                      entry_cf.astype(np.int64), k)
            if pieces is not None and _fits(pieces[0]):
                return pack_ic_best(*pieces, k), b"ic"
        return best_sidecar(glen, meta16, cfv), b"ib"
    if index == "ic":
        if spans is None:
            spans, entry = chunk_spans(glen.astype(np.int64), rung, entry_runbits, k)
        return (pack_ic(spans, entry, k), b"ic") if _fits(spans) else (None, b"ix")
    return glen.astype("<u2").tobytes(), b"ix"


class Frame(NamedTuple):
    """What a stream's header names besides its mode and sidecar."""

    xsize: int
    ysize: int
    nbands: int
    dtype: int
    cband: list
    quanta: int
    order: int

    def header(self, mode: int, index: bytes | None = None, sig: bytes = b"ix") -> bytes:
        return container.write_headers(self.xsize, self.ysize, self.nbands, self.dtype, mode,
                                       self.cband, self.quanta, self.order, index, sig)

    def stored(self, raw: np.ndarray) -> bytes:
        """The raw raster as a STORED stream."""
        return self.header(Mode.STORED) + raw.tobytes()

    def finish(self, user_mode: int, payload: bytes, side: tuple, max_size: int,
               raw: np.ndarray | None = None, store_rle: bool = False) -> bytes:
        """The whole stream of a payload coded in RLE_BASE's mode for
        user_mode, with side, sidecar's result.  An RLE mode's payload takes
        the RLE0 post-pass where the stream is at most half of max_size and
        the pass shrinks it within max_size (QB3encode.cpp:536-566).  Else
        the raw raster, where given, is stored unless the coded stream is
        smaller; an RLE mode keeps its coded stream unless store_rle."""
        result = self.header(RLE_BASE.get(user_mode, user_mode), *side) + payload
        if needs_rle(user_mode):
            if len(result) <= max_size // 2:
                with profiling.span("finish.rle0"):
                    packed = rle.rle0_encode(payload)
                if len(packed) < len(payload) and len(packed) <= max_size - len(result):
                    return self.header(user_mode, *side) + packed
            if not store_rle:
                return result
        if raw is not None and raw.nbytes <= len(result):
            return self.stored(raw)
        return result


def is_stored(stream: bytes) -> bool:
    """Whether a stream is STORED: the main header's last byte is its mode
    (container.py)."""
    return stream[10] == Mode.STORED
