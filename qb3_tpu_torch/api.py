"""Public encoder/decoder API on PyTorch, mirroring qb3_tpu/api.py.

    enc = Encoder(width, height, bands, DType.U8, device="cuda")
    enc.set_mode(Mode.FTL)
    enc.with_index = "ic"
    stream = enc.encode(img)          # bytes, equal to qb3_tpu's

    info, img = decode(stream)        # full decode

Phase A (ops/encode.py) and the pack (K1) run on the given device; this
module is the host-side orchestration: validation, quantization, small
image repacking, container framing, the RLE0 post-pass and the fallbacks
(qb3_encode, QB3encode.cpp:488-574).

Slice covered: FTL, BASE_H and BASE_Z (and their RLE forms) with no sidecar
or the self-contained "ic" sidecar; the Decoder decodes stored and "ic"
streams.  Everything else raises NotImplementedError naming the ROADMAP.md
item that ports it; nothing runs on another device instead.
"""

from __future__ import annotations

import numpy as np
import torch

from . import container, rle
from .constants import (
    B,
    B2,
    HILBERT,
    QB3_MAXBANDS_EXT,
    TYPESIZES,
    ZCURVE,
    DType,
    Error,
    Mode,
    is_best_mode,
    is_fast_mode,
    mode_uses_zcurve,
    needs_rle,
)
from .errors import QB3DataError, QB3Error, QB3HeaderError, QB3ShapeError
from .ops.bitpack import group_bits_bound, pack_groups_auto, words_to_bytes
from .ops.chunkwalk_cuda import ic_walk_params
from .ops.decode import payload_words, reconstruct
from .ops.decode_chunked import (IC_DEFAULT_K, chunk_spans, decode_chunked_auto,
                                 pack_ic, parse_ic)
from .ops.encode import encode_fast_blocks

NP_FROM_DT = {
    DType.U8: np.uint8, DType.I8: np.int8, DType.U16: np.uint16, DType.I16: np.int16,
    DType.U32: np.uint32, DType.I32: np.int32, DType.U64: np.uint64, DType.I64: np.int64,
}
DT_FROM_NP = {np.dtype(v): k for k, v in NP_FROM_DT.items()}
UNSIGNED = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}
# signed twins for moving unsigned data in and out of torch
_TORCH_SIGNED = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
_NP_SIGNED = {1: np.uint8, 2: np.int16, 4: np.int32, 8: np.int64}

_NOT_PORTED = {
    "walk": "ROADMAP.md Queue 1 item 10 (slice 2: decode without a sidecar, "
            "the serial walk)",
    "ix": "ROADMAP.md Queue 1 item 11 (slice 3: the ix sidecar)",
    "best": "ROADMAP.md Queue 1 item 12 (slice 4: best mode, ib and ic-best)",
}


def not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"not ported yet: {_NOT_PORTED[what]}")


def default_cband(nbands: int) -> list[int]:
    """RGB(A) default: R-G, G, B-G (QB3encode.cpp:40-45)."""
    cband = list(range(nbands))
    if nbands in (3, 4):
        cband[0] = cband[2] = 1
    return cband


def normalize_cband(nbands: int, cband) -> list[int]:
    """Clamp invalid entries and force core bands independent
    (QB3encode.cpp:63-77)."""
    cb = [cband[i] if cband[i] < nbands else i for i in range(nbands)]
    for i in range(nbands):
        if cb[i] != i:
            cb[cb[i]] = cb[i]
    return cb


def max_encoded_size(xsize: int, ysize: int, nbands: int, dtype: int) -> int:
    """Worst-case output bytes (QB3encode.cpp:112-118)."""
    n = 16 * ((xsize + 3) // 4) * ((ysize + 3) // 4) * nbands
    bits_per_value = 17.0 / 16.0 + 8 * TYPESIZES[dtype]
    return 1024 + int(bits_per_value * n / 8)


# ---------------------------------------------------------------- quantization

def _tdiv(n, d):
    """C-style truncating integer division (toward zero)."""
    q = n // d
    return q + ((n % d != 0) & (n < 0))


def _tmod(n, d):
    return n - _tdiv(n, d) * d


def quantize(arr: np.ndarray, q: int, away: bool) -> np.ndarray:
    """In the signed domain, round-to/away-from-zero (QB3encode.cpp:137-186)."""
    v = arr
    d = np.array(q, dtype=arr.dtype)
    if q == 2:
        return (_tdiv(v, d) + _tmod(v, d)).astype(arr.dtype) if away else _tdiv(v, d).astype(arr.dtype)
    if q == 3:
        return (_tdiv(v, d) + _tdiv(_tmod(v, d), np.array(2, arr.dtype))).astype(arr.dtype)
    if q == 4:
        sub = 2 if away else 3
        return (_tdiv(v, d) + _tdiv(_tmod(v, d), np.array(sub, arr.dtype))).astype(arr.dtype)
    m = _tmod(v, d)
    if away:
        h = _tdiv(d, np.array(2, arr.dtype)) + _tmod(d, np.array(2, arr.dtype))
        return (_tdiv(v, d) + (~(v < 0) & (m >= h)) - ((v < 0) & ((m + h) <= 0))).astype(arr.dtype)
    h = _tdiv(d, np.array(2, arr.dtype))
    return (_tdiv(v, d) + (~(v < 0) & (m > h)) - ((v < 0) & ((m + h) < 0))).astype(arr.dtype)


def dequantize(arr: np.ndarray, q: int) -> np.ndarray:
    """Clamped multiply-back (QB3decode.cpp:77-107)."""
    info = np.iinfo(arr.dtype)
    qa = np.array(q, dtype=arr.dtype)
    mai = np.array(info.max // q, dtype=arr.dtype)
    out = np.where(arr <= mai, arr * qa, np.array(info.max, arr.dtype))
    if info.min < 0 and q > 2:
        # trunc(min/q), matching the C division semantics
        mii = np.array(int(info.min) // q + (1 if int(info.min) % q else 0), arr.dtype)
        out = np.where(arr < mii, np.array(info.min, arr.dtype), out)
    return out.astype(arr.dtype)


# -------------------------------------------------------------- small images

def repack_small(img: np.ndarray) -> np.ndarray:
    """Repack an image with a dimension < 4 into a B-aligned layout
    (QB3encode.cpp:351-389)."""
    h, w, nb = img.shape
    ngroups = (h * w + B2 - 1) // B2
    flat = np.zeros((ngroups * B2 * nb,), dtype=img.dtype)
    if w < B:  # narrow and tall: row by row
        data = img.reshape(-1)
        flat[: data.size] = data
        return flat.reshape(ngroups * B, B, nb)
    # short and wide: column by column
    data = img.transpose(1, 0, 2).reshape(-1)
    flat[: data.size] = data
    return flat.reshape(B, ngroups * B, nb)


def unpack_small(img: np.ndarray, h: int, w: int, nb: int) -> np.ndarray:
    """Inverse of repack_small (QB3decode.cpp:337-353)."""
    flat = img.reshape(-1)[: h * w * nb]
    if w < B:
        return flat.reshape(h, w, nb)
    return flat.reshape(w, h, nb).transpose(1, 0, 2)


# ------------------------------------------------------- host <-> device

def to_carrier(uns: np.ndarray, device) -> torch.Tensor:
    """Unsigned numpy array -> int64 carrier tensor on `device` (bitutils.py):
    the copy moves the native width, the widening runs on the device."""
    size = uns.dtype.itemsize
    uns = np.require(uns, requirements=["C", "W"])  # torch wants writable memory
    t = torch.from_numpy(uns.view(_NP_SIGNED[size])).to(device)
    if size == 8:
        return t
    return t.to(torch.int64) & ((1 << (8 * size)) - 1)


def from_carrier(t: torch.Tensor, size: int) -> np.ndarray:
    """int64 carrier of `size`-byte unsigned values -> numpy unsigned array:
    narrowed on the device, then copied to the host."""
    if size not in (1, 8):
        half = 1 << (8 * size - 1)
        t = torch.where(t >= half, t - 2 * half, t)  # exact in the signed twin
    return t.to(_TORCH_SIGNED[size]).cpu().numpy().view(UNSIGNED[size])


# ------------------------------------------------------------------- encoder

def fast_encode(img, entry_prev, entry_runbits, order: int, cband: tuple,
                skipstep: bool, tbits: int, n_words: int, lanewise=None):
    """Device-resident fast encode (FTL/BASE): phase A, then the K1 pack.

    img (..., H, W, C) int64 carrier; returns (words (..., n_words) int32,
    total bits, exit_prev, exit_runbits, glen, rung)."""
    codes, lens, exit_prev, exit_runbits, rung = encode_fast_blocks(
        img, entry_prev, entry_runbits, order, cband, skipstep, tbits,
        with_rungs=True, lanewise=lanewise)
    words, total, glen = pack_groups_auto(codes, lens, n_words,
                                          group_bits_bound(tbits, best=False))
    return words, total, exit_prev, exit_runbits, glen, rung


class Encoder:
    """Mirror of the encsp handle (QB3encode.cpp:26-57); phase A and the
    pack run on `device`."""

    def __init__(self, width: int, height: int, bands: int, dtype: DType,
                 device="cuda"):
        if not (0 < width <= 0x10000 and 0 < height <= 0x10000
                and 0 < bands <= QB3_MAXBANDS_EXT and 0 <= dtype <= DType.I64):
            raise ValueError("invalid encoder parameters")
        self.device = torch.device(device)
        self.xsize = width
        self.ysize = height
        self.nbands = bands
        self.dtype = DType(dtype)
        self.quanta = 1
        self.away = False
        self.mode = Mode.FTL
        self.order = 0
        self.stride = 0
        self.cband = default_cband(bands)
        self.error = Error.OK
        # decode sidecar: False, or "ic" (chunked anchors, ~1%)
        self.with_index = False
        self.index_chunk_blocks = 0  # 0 = IC_DEFAULT_K
        self._last_glens = None
        self._last_rungs = None
        self.reset()

    def reset(self):
        """qb3_reset_encoder: clear persisted band state."""
        self.band_prev = np.zeros(self.nbands, dtype=np.uint64)
        self.band_runbits = np.zeros(self.nbands, dtype=np.int32)
        self.error = Error.OK

    def set_mode(self, mode: int) -> Mode:
        if 0 <= mode < Mode.END:
            self.mode = Mode(mode)
        if mode_uses_zcurve(self.mode):
            self.order = ZCURVE  # sticky, like QB3encode.cpp:120-134
        return self.mode

    def set_quanta(self, q: int, away: bool = False) -> bool:
        if q < 1:
            return False
        self.quanta = int(q)
        self.away = bool(away)
        if q == 1:
            return True
        np_dt = NP_FROM_DT[self.dtype]
        return q <= np.iinfo(np_dt).max

    def set_coreband(self, cband) -> list[int]:
        self.cband = normalize_cband(self.nbands, list(cband))
        return self.cband

    def set_stride(self, stride: int):
        self.stride = stride

    def max_encoded_size(self) -> int:
        return max_encoded_size(self.xsize, self.ysize, self.nbands, self.dtype)

    # ---------------------------------------------------------------- encode

    def _source_view(self, source: np.ndarray) -> np.ndarray:
        """Apply stride and shape checks -> contiguous (H, W, C) array."""
        np_dt = NP_FROM_DT[self.dtype]
        src = np.asarray(source)
        if src.dtype != np.dtype(np_dt):
            raise QB3ShapeError(f"dtype mismatch: {src.dtype} vs {np_dt}")
        if self.stride:
            flat = src.reshape(-1)
            rows = [flat[y * self.stride:(y * self.stride) + self.xsize * self.nbands]
                    for y in range(self.ysize)]
            src = np.stack(rows).reshape(self.ysize, self.xsize, self.nbands)
        else:
            src = src.reshape(self.ysize, self.xsize, self.nbands)
        return np.ascontiguousarray(src)

    def _stored(self, raw: np.ndarray) -> bytes:
        hdr = container.write_headers(
            self.xsize, self.ysize, self.nbands, self.dtype, Mode.STORED,
            self.cband, self.quanta, self.order)
        return hdr + raw.tobytes()

    def encode(self, source: np.ndarray) -> bytes:
        """qb3_encode (QB3encode.cpp:488-574).

        The error state is sticky like the reference handle's
        (qb3_get_encoder_state, QB3encode.cpp:338): a failed encode sets
        `self.error` and further encodes raise until reset()."""
        if self.error != Error.OK:
            raise QB3Error(f"encoder in error state {self.error!r}; reset() first")
        try:
            return self._encode(source)
        except QB3Error:
            self.error = Error.EINV
            raise

    def _encode(self, source: np.ndarray) -> bytes:
        if self.with_index not in (False, "ic"):
            raise not_ported("ix")
        src = self._source_view(source)
        raw_size = src.nbytes
        if self.xsize * self.ysize <= B2:
            return self._stored(src)

        user_mode = self.mode
        mode = user_mode
        if needs_rle(mode):
            mode = {Mode.RLE: Mode.BASE_Z, Mode.CF_RLE: Mode.CF,
                    Mode.RLE_H: Mode.BASE_H, Mode.CF_RLE_H: Mode.CF_H}[mode]
        if not is_fast_mode(mode):
            raise not_ported("best")

        work = src
        if self.quanta >= 2:
            work = quantize(work, self.quanta, self.away)
        uns = work.view(UNSIGNED[work.dtype.itemsize])

        if self.xsize < B or self.ysize < B:
            uns = repack_small(uns)

        entry_runbits = self.band_runbits.copy()
        payload, state = self._encode_payload(uns, mode)
        index, index_sig = None, b"ix"
        if self.with_index == "ic":
            index, index_sig = self._chunked_sidecar(entry_runbits), b"ic"
        header = container.write_headers(
            self.xsize, self.ysize, self.nbands, self.dtype, mode,
            self.cband, self.quanta, self.order, index, index_sig)
        result = header + payload

        if needs_rle(user_mode):
            # RLE post-pass: only if reasonable and it shrinks (QB3encode.cpp:536-566)
            if len(result) <= self.max_encoded_size() // 2:
                packed = rle.rle0_encode(payload)
                if len(packed) < len(payload) and \
                        len(packed) <= self.max_encoded_size() - len(result):
                    header2 = container.write_headers(
                        self.xsize, self.ysize, self.nbands, self.dtype, user_mode,
                        self.cband, self.quanta, self.order, index, index_sig)
                    self._commit_state(state)
                    return header2 + packed
            self._commit_state(state)
            return result

        if raw_size > len(result):
            self._commit_state(state)
            return result
        return self._stored(src)

    def _encode_payload(self, uns: np.ndarray, mode: Mode):
        h, w, nb = uns.shape
        tbits = uns.dtype.itemsize * 8
        n_words = (max_encoded_size(w, h, nb, self.dtype) + 3) // 4 + 2
        prev = to_carrier(self.band_prev.astype(uns.dtype), self.device)
        runbits = torch.from_numpy(self.band_runbits).to(self.device)
        words, total, xprev, xrun, glen, rung = fast_encode(
            to_carrier(uns, self.device), prev, runbits, self.order or HILBERT,
            tuple(self.cband), mode == Mode.FTL, tbits, n_words)
        state = (from_carrier(xprev, uns.dtype.itemsize), xrun.cpu().numpy())
        self._last_rungs = rung.cpu().numpy()
        self._last_glens = glen.cpu().numpy()
        total = int(total)
        used = words[: (total + 31) // 32].cpu().numpy().view(np.uint32)
        return words_to_bytes(used, total), state

    def _chunked_sidecar(self, entry_runbits: np.ndarray) -> bytes | None:
        """"ic" chunk payload: per-chunk bit spans + entry rung state
        (ops/decode_chunked.py has the format)."""
        k = self.index_chunk_blocks or IC_DEFAULT_K
        spans, entry = chunk_spans(self._last_glens.astype(np.int64),
                                   self._last_rungs, entry_runbits, k)
        if int(spans.sum()) >= 1 << 31:
            return None  # int32 bit cursors in the device walk
        return pack_ic(spans, entry, k)

    def _commit_state(self, state):
        xprev, xrun = state
        self.band_prev = xprev.astype(np.uint64)
        self.band_runbits = xrun.astype(np.int32)


# ------------------------------------------------------------------- decoder

def padded_words(payload: bytes) -> np.ndarray:
    """Payload -> u64 words zero-padded to a power of two (at least 16):
    the decoders' stream buffer, as qb3_tpu pads it."""
    words = payload_words(payload)
    wpad = np.zeros(1 << max(4, int(np.ceil(np.log2(len(words))))), np.uint64)
    wpad[: len(words)] = words
    return wpad


def ic_inputs(words: np.ndarray, metas: list, tile_words32: int, tbits: int,
              device) -> dict:
    """Device inputs of the "ic" decode.

    words: u64 stream words, one padded payload or a batch in the flat tile
    layout whose tiles start tile_words32 u32 words apart; metas: parse_ic's
    result per tile.  Returns words32, starts, entry and k, plus (maxw, R)
    for the u8/u16 chunk walk, computed once here (None for wider types).
    """
    tbase = (np.arange(len(metas), dtype=np.int64) * tile_words32 * 32)[:, None]
    starts = (np.stack([m[1] for m in metas]) + tbase).reshape(-1)
    spans = np.concatenate([np.diff(np.append(m[1], m[3])) for m in metas])
    maxw, R = ic_walk_params(starts, spans) if tbits <= 16 else (None, None)
    return dict(words32=torch.from_numpy(words.reshape(-1).view(np.int32)).to(device),
                starts=torch.from_numpy(starts.astype(np.int32)).to(device),
                entry=torch.from_numpy(np.concatenate([m[2] for m in metas])).to(device),
                k=metas[0][0], maxw=maxw, R=R)


def ic_decode(inp: dict, nblocks: int, nb: int, h: int, w: int, order: int,
              cband: tuple, apply_step: bool, tbits: int):
    """Device-resident "ic" decode of one image (inputs from ic_inputs):
    the chunk walk, then reconstruct -> (H, W, C) int64 carrier."""
    g = decode_chunked_auto(inp["words32"], inp["starts"], inp["entry"], inp["k"],
                            nblocks, nb, apply_step, tbits, inp["maxw"], inp["R"])
    zero = torch.zeros(nb, dtype=torch.int64, device=g.device)
    img, _ = reconstruct(g.reshape(nblocks, nb, B2), zero, h, w, nb, order,
                         cband, tbits)
    return img


class Decoder:
    """Mirror of the 3-stage decsp reader (QB3decode.cpp:130-264); the
    decode runs on `device`.

    After read_data, `decode_path` records which decode engine ran
    ("stored" or "ic"); `failed` mirrors the reference's decode failure flag
    when read_data(partial=True) returned best-effort output.
    """

    def __init__(self, stream: bytes, device="cuda"):
        self.stream = stream
        self.device = torch.device(device)
        self.info = container.parse_headers(stream)  # read_start + read_info
        self.stride = 0
        self.failed = False
        self.decode_path = None

    @property
    def image_size(self):
        return self.info.xsize, self.info.ysize, self.info.nbands

    def decoded_size(self) -> int:
        i = self.info
        return i.xsize * i.ysize * i.nbands * TYPESIZES[i.dtype]

    def set_stride(self, stride: int):
        self.stride = stride

    def read_data(self, partial: bool = False) -> np.ndarray:
        """qb3_read_data -> (H, W, C) array in the stream's dtype.

        On payload corruption, raises QB3DataError by default; with
        partial=True it instead sets `self.failed` and returns the
        best-effort output (QB3decode.h:713-716).
        """
        info = self.info
        np_dt = NP_FROM_DT[DType(info.dtype)]
        uns_dt = UNSIGNED[np.dtype(np_dt).itemsize]
        data = self.stream[info.data_offset:]
        h, w, nb = info.ysize, info.xsize, info.nbands

        if info.mode == Mode.STORED:
            self.decode_path = "stored"
            if len(data) != self.decoded_size():
                raise QB3DataError("stored payload size mismatch")
            out = np.frombuffer(data, dtype=np_dt).reshape(h, w, nb).copy()
            return self._finish(out)

        if h * w < B2:
            raise QB3HeaderError("tiny images must be stored")

        if needs_rle(info.mode):
            expected = rle.rle0_decoded_size(data)
            if expected > self.decoded_size():
                # malicious-input guard (QB3decode.cpp:399-404)
                raise QB3DataError("RLE expansion exceeds image size")
            data = rle.rle0_decode(data, expected)

        dh, dw = h, w
        if w < B or h < B:
            ngroups = (h * w + B2 - 1) // B2
            dw, dh = (B, ngroups * B) if w < B else (ngroups * B, B)

        try:
            uns = self._decode_core(data, dh, dw, nb, uns_dt)
        except QB3DataError as e:
            if not partial or e.partial is None:
                raise
            self.failed = True
            uns = e.partial
        if (dh, dw) != (h, w):
            uns = unpack_small(uns, h, w, nb)
        out = uns.view(np_dt)
        if info.quanta > 1:
            out = dequantize(out, info.quanta)
        return self._finish(out)

    def _decode_core(self, data: bytes, h: int, w: int, nb: int, uns_dt) -> np.ndarray:
        info = self.info
        if is_best_mode(info.mode):
            raise not_ported("best")
        nblocks = ((h + B - 1) // B) * ((w + B - 1) // B)
        # like qb3_tpu, RLE-wrapped streams (not a fast mode) take the walk
        fast = is_fast_mode(info.mode)
        meta = None
        if info.index_chunked is not None and fast:
            meta = parse_ic(info.index_chunked, nblocks, nb)
        if meta is None:
            raise not_ported("ix" if info.index is not None and fast else "walk")

        tbits = 8 * np.dtype(uns_dt).itemsize
        inp = ic_inputs(padded_words(data), [meta], 0, tbits, self.device)
        img = ic_decode(inp, nblocks, nb, h, w, info.order or HILBERT,
                        tuple(info.cband), info.mode != Mode.FTL, tbits)
        self.decode_path = "ic"
        return self._end_check(from_carrier(img, tbits // 8), len(data) * 8 - meta[3])

    def _end_check(self, img: np.ndarray, leftover: int) -> np.ndarray:
        """The reference end-of-stream rule: >7 bits of extra input fail
        (QB3decode.h:411, :744); truncated input decodes as zeros."""
        if leftover > 7:
            raise QB3DataError(f"{leftover} leftover bits", partial=img)
        return img

    def _finish(self, out: np.ndarray) -> np.ndarray:
        if self.stride:
            h, w, nb = out.shape
            buf = np.zeros((h * self.stride,), dtype=out.dtype)
            line = w * nb
            for y in range(h):
                buf[y * self.stride : y * self.stride + line] = out[y].reshape(-1)
            return buf
        return out


def decode(stream: bytes, device="cuda"):
    """One-shot decode -> (array (H, W, C), StreamInfo)."""
    dec = Decoder(stream, device)
    return dec.read_data(), dec.info


def encode(img: np.ndarray, mode: int = Mode.FTL, quanta: int = 1,
           away: bool = False, coreband=None, index=False, device="cuda") -> bytes:
    """One-shot convenience encoder for (H, W[, C]) arrays."""
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    enc = Encoder(w, h, c, DT_FROM_NP[img.dtype], device)
    enc.set_mode(mode)
    enc.with_index = index
    if quanta != 1:
        enc.set_quanta(quanta, away)
    if coreband is not None:
        enc.set_coreband(coreband)
    return enc.encode(img)
