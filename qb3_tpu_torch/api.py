"""Public encoder/decoder API on PyTorch, mirroring qb3_tpu/api.py.

    enc = Encoder(width, height, bands, DType.U8, device="cuda")
    enc.set_mode(Mode.FTL)
    enc.with_index = "ic"
    stream = enc.encode(img)          # bytes, equal to qb3_tpu's

    info, img = decode(stream)        # full decode

Phase A (K9, and K10 in the best modes, ops/phase_a_cuda.py; on the CPU
their twins in ops/encode.py and ops/encode_best.py) and the pack (K1) run
on the given device; this module is the host-side
orchestration: validation, quantization and small image repacking; the
sidecar, the header, the RLE0 post-pass and the stored fallback come from
framing.py (qb3_encode, QB3encode.cpp:488-574).  u16/u32/u64 images whose
sides are multiples of 4 take the image-layout phase A (ops/encode_image.py)
and K8 (ops/encode_cuda.py) instead, to the same bytes (takes_fused).

Every mode is covered: the encode of FTL, BASE_H and BASE_Z with no
sidecar, the self-contained "ic" sidecar or the "ix" sidecar (per-group bit
lengths), and of the best modes CF and CF_H (phase A in K10, then K1)
with no sidecar, the "ib" sidecar (per-group lengths and decode
metadata) or the best modes' "ic" sidecar, each with its RLE form; the
Decoder decodes stored, "ic" and "ix" streams, best-mode streams with the
"ib" sidecar (K7 and K5) or their "ic" sidecar (the chunk walk of
ops/decode_chunked.decode_chunked_best, plain PyTorch on the device), and
streams of any mode without a usable sidecar through the serial walk on the
host (native.py, or offsets.py where the C++ walk cannot be built), K7 and
K5 on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from . import container, framing, profiling, rle
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
from .offsets import KIND_CF, KIND_CF0, parse_offsets
from .ops.decode import (_NREG_IX, K5_KIND, decode_groups, decode_indexed_narrow,
                         payload_words, reconstruct)
from .ops.decode_chunked import (IC_DEFAULT_K, decode_chunked_auto, decode_chunked_best,
                                 parse_ic, parse_ic_best)
from .ops.encode_cuda import encode_pack_image, image_pack_args
from .ops.encode_image import phase_a_image
from .ops.fusedwin_cuda import ix_window_R
from .ops.gather_cuda import gather_span
from .ops.phase_a_cuda import phase_a_best, phase_a_fast

NP_FROM_DT = {
    DType.U8: np.uint8, DType.I8: np.int8, DType.U16: np.uint16, DType.I16: np.int16,
    DType.U32: np.uint32, DType.I32: np.int32, DType.U64: np.uint64, DType.I64: np.int64,
}
DT_FROM_NP = {np.dtype(v): k for k, v in NP_FROM_DT.items()}
UNSIGNED = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}
# signed twins for moving unsigned data in and out of torch
_TORCH_SIGNED = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
_NP_SIGNED = {1: np.uint8, 2: np.int16, 4: np.int32, 8: np.int64}


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


def stream_words(xsize: int, ysize: int, nbands: int, dtype: int) -> int:
    """The encoder's stream buffer in u32 words: the worst case and two
    words of slack."""
    return (max_encoded_size(xsize, ysize, nbands, dtype) + 3) // 4 + 2


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

def widen(t: torch.Tensor, size: int) -> torch.Tensor:
    """The signed twin of `size`-byte unsigned values -> the int64 carrier,
    widened on the tensor's device."""
    if size == 8:
        return t
    return t.to(torch.int64) & ((1 << (8 * size)) - 1)


def to_carrier(uns: np.ndarray, device) -> torch.Tensor:
    """Unsigned numpy array -> int64 carrier tensor on `device` (bitutils.py):
    the copy moves the native width, the widening runs on the device."""
    size = uns.dtype.itemsize
    uns = np.require(uns, requirements=["C", "W"])  # torch wants writable memory
    return widen(torch.from_numpy(uns.view(_NP_SIGNED[size])).to(device), size)


def narrow(t: torch.Tensor, size: int) -> torch.Tensor:
    """int64 carrier of `size`-byte unsigned values -> their signed twin at
    the type's width, narrowed on the tensor's device."""
    if size not in (1, 8):
        half = 1 << (8 * size - 1)
        t = torch.where(t >= half, t - 2 * half, t)  # exact in the signed twin
    return t.to(_TORCH_SIGNED[size])


def from_carrier(t: torch.Tensor, size: int) -> np.ndarray:
    """int64 carrier of `size`-byte unsigned values -> numpy unsigned array:
    narrowed on the device, then copied to the host."""
    return narrow(t, size).cpu().numpy().view(UNSIGNED[size])


# ------------------------------------------------------------------- encoder

def fast_encode(img, entry_prev, entry_runbits, order: int, cband: tuple,
                skipstep: bool, tbits: int, n_words: int, lanewise=None):
    """Device-resident fast encode (FTL/BASE): phase A (K9, or its twin
    on the CPU), then the K1 pack.

    img (..., H, W, C) int64 carrier; returns (words (..., n_words) int32,
    total bits, exit_prev, exit_runbits, glen, rung).  Spans (profiling):
    encode.phase_a and encode.pack, on the device's current stream."""
    tiles = img.shape[0] if img.dim() == 4 else 1
    with profiling.span("encode.phase_a", tiles, img.device):
        codes, lens, exit_prev, exit_runbits, rung = phase_a_fast(
            img, entry_prev, entry_runbits, order, cband, skipstep, tbits,
            with_rungs=True, lanewise=lanewise)
    with profiling.span("encode.pack", tiles, img.device):
        words, total, glen = pack_groups_auto(codes, lens, n_words,
                                              group_bits_bound(tbits, best=False))
    return words, total, exit_prev, exit_runbits, glen, rung


def best_encode(img, entry_prev, entry_runbits, entry_cf, order: int, cband: tuple,
                tbits: int, n_words: int):
    """Device-resident best encode (CF / CF_H): phase A (K10, or its twin
    ops/encode_best.encode_best_blocks on the CPU), then the K1 pack at the
    best modes' symbol counts (qb3_tpu's _best_kernel).

    img (..., H, W, C) int64 carrier; returns (words (..., n_words) int32,
    total bits, exit_prev, exit_runbits, exit_cf, glen, meta16, cfv,
    post_runbits, pcf_in), the last four as encode_best_blocks gives them."""
    (codes, lens, exit_prev, exit_runbits, exit_cf, meta16, cfv, post_run,
     pcf_in) = phase_a_best(img, entry_prev, entry_runbits, entry_cf, order, cband, tbits)
    words, total, glen = pack_groups_auto(codes, lens, n_words,
                                          group_bits_bound(tbits, best=True))
    return (words, total, exit_prev, exit_runbits, exit_cf, glen, meta16, cfv, post_run,
            pcf_in)


def takes_fused(tbits: int, h: int, w: int) -> bool:
    """Whether one image encodes through fused_encode: u16, u32 and u64
    images whose sides are multiples of 4 (K8's domain).  u8 images, and
    batches (batch.py), take fast_encode."""
    return tbits >= 16 and h % B == 0 and w % B == 0


def fused_encode(img, entry_prev, entry_runbits, order: int, cband: tuple,
                 skipstep: bool, tbits: int, n_words: int):
    """Device-resident image-layout fast encode: the image-layout phase A,
    then K8 packs straight from the mag-sign plane.

    img (H, W, C) int64 carrier, H and W multiples of 4; returns what
    fast_encode returns, with the same values."""
    o = phase_a_image(img, entry_prev, entry_runbits, order, cband, skipstep, tbits)
    words, total, glen = encode_pack_image(*image_pack_args(o, tbits, n_words, order))
    return words, total, o["exit_prev"], o["exit_runbits"], glen, o["rung"]


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
        # decode sidecar: False, True/"ix" (per-group bit lengths, u16 each;
        # "ib" in the best modes) or "ic" (chunked anchors, ~1%)
        self.with_index = False
        self.index_chunk_blocks = 0  # 0 = IC_DEFAULT_K
        self.reset()

    def reset(self):
        """qb3_reset_encoder: clear persisted band state."""
        self.band_prev = np.zeros(self.nbands, dtype=np.uint64)
        self.band_runbits = np.zeros(self.nbands, dtype=np.int32)
        self.band_cf = np.zeros(self.nbands, dtype=np.uint64)
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

    def _frame(self) -> framing.Frame:
        return framing.Frame(self.xsize, self.ysize, self.nbands, self.dtype, self.cband,
                             self.quanta, self.order)

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
        src = self._source_view(source)
        if self.xsize * self.ysize <= B2:
            return self._frame().stored(src)

        work = src
        if self.quanta >= 2:
            work = quantize(work, self.quanta, self.away)
        uns = work.view(UNSIGNED[work.dtype.itemsize])

        if self.xsize < B or self.ysize < B:
            uns = repack_small(uns)

        payload, state, pieces = self._encode_payload(
            uns, framing.RLE_BASE.get(self.mode, self.mode))
        # entry_cf: the one-shot encode alone tries the best modes' "ic"
        # sidecar (qb3_tpu/api.py:346-352)
        side = framing.sidecar(self.with_index, **pieces, entry_runbits=self.band_runbits,
                               k=self.index_chunk_blocks or IC_DEFAULT_K, entry_cf=self.band_cf)
        stream = self._frame().finish(self.mode, payload, side, self.max_encoded_size(), raw=src)
        if not framing.is_stored(stream):
            self._commit_state(state)
        return stream

    def _encode_words(self, uns: np.ndarray, mode: Mode):
        """Phase A and the pack of one (H, W, C) unsigned raster from the
        persisted band state, on the device -> (the stream words used, a view
        of the first ceil(total / 32) words on the device; total bits; the
        exit (prev, runbits, cf or None) on the host; glen; rung, the
        decoder-observable runbits after each block; in the best modes
        (meta16, cfv, pcf_in) on the device, else None)."""
        h, w, nb = uns.shape
        size = uns.dtype.itemsize
        tbits = size * 8
        n_words = stream_words(w, h, nb, self.dtype)
        args = (to_carrier(uns, self.device),
                to_carrier(self.band_prev.astype(uns.dtype), self.device),
                torch.from_numpy(self.band_runbits).to(self.device))
        order, cband = self.order or HILBERT, tuple(self.cband)
        if is_best_mode(mode):
            cf = to_carrier(self.band_cf.astype(uns.dtype), self.device)
            (words, total, xprev, xrun, xcf, glen, meta16, cfv, rung,
             pcf_in) = best_encode(*args, cf, order, cband, tbits, n_words)
            best, xcf = (meta16, cfv, pcf_in), from_carrier(xcf, size)
        elif is_fast_mode(mode):
            words, total, xprev, xrun, glen, rung = (
                fused_encode if takes_fused(tbits, h, w) else fast_encode)(
                *args, order, cband, mode == Mode.FTL, tbits, n_words)
            best = xcf = None
        else:
            raise ValueError(f"unsupported mode {mode}")
        state = (from_carrier(xprev, size), xrun.cpu().numpy(), xcf)
        total = int(total)
        return words[: (total + 31) // 32], total, state, glen, rung, best

    def _encode_payload(self, uns: np.ndarray, mode: Mode):
        """_encode_words' stream as bytes -> (payload, exit state, the
        sidecar's pieces on the host for framing.sidecar: glen and rung, in
        the best modes meta16, cfv and pcf_in too; none without a
        sidecar)."""
        used, total, state, glen, rung, best = self._encode_words(uns, mode)
        pieces = {}
        if self.with_index:
            pieces = dict(glen=glen, rung=rung)
            if best is not None:
                pieces.update(zip(("meta16", "cfv", "pcf_in"), best))
            pieces = {k: v.cpu().numpy() for k, v in pieces.items()}
        return words_to_bytes(used.cpu().numpy().view(np.uint32), total), state, pieces

    def _commit_state(self, state):
        xprev, xrun, xcf = state
        self.band_prev = xprev.astype(np.uint64)
        self.band_runbits = xrun.astype(np.int32)
        if xcf is not None:
            self.band_cf = xcf.astype(np.uint64)


# ------------------------------------------------------------------- decoder

def padded_words(payload: bytes) -> np.ndarray:
    """Payload -> u64 words zero-padded to a power of two (at least 16):
    the decoders' stream buffer, as qb3_tpu pads it."""
    words = payload_words(payload)
    wpad = np.zeros(1 << max(4, int(np.ceil(np.log2(len(words))))), np.uint64)
    wpad[: len(words)] = words
    return wpad


def put_on(device):
    """The decode inputs' host-to-device copy: a numpy array -> a tensor on
    `device` (a copy from pageable memory; pipeline.Lanes.put copies through
    page-locked memory instead)."""
    return lambda arr: torch.from_numpy(np.require(arr, requirements=["C", "W"])).to(device)


def ic_inputs(words: np.ndarray, metas: list, tile_words32: int, tbits: int,
              device, put=None) -> dict:
    """Device inputs of the "ic" decode.

    words: u64 stream words, one padded payload or a batch in the flat tile
    layout whose tiles start tile_words32 u32 words apart; metas: parse_ic's
    result per tile; put: the host-to-device copy (put_on(device) if None).
    Returns words32, starts, entry and k, plus (maxw, R) for the u8/u16
    chunk walk, computed once here (None for wider types).
    """
    tbase = (np.arange(len(metas), dtype=np.int64) * tile_words32 * 32)[:, None]
    starts = (np.stack([m[1] for m in metas]) + tbase).reshape(-1)
    spans = np.concatenate([np.diff(np.append(m[1], m[3])) for m in metas])
    maxw, R = ic_walk_params(starts, spans) if tbits <= 16 else (None, None)
    put = put or put_on(device)
    return dict(words32=put(words.reshape(-1).view(np.int32)),
                starts=put(starts.astype(np.int32)),
                entry=put(np.concatenate([m[2] for m in metas])),
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


def ic_best_inputs(words: np.ndarray, meta: tuple, device) -> dict:
    """Device inputs of the best modes' "ic" decode of one stream: the
    padded stream words (padded_words) and parse_ic_best's result."""
    k, starts, entry, pcf, _ = meta
    return dict(words32=torch.from_numpy(words.view(np.int32)).to(device),
                starts=torch.from_numpy(starts.astype(np.int32)).to(device),
                entry=torch.from_numpy(entry).to(device),
                pcf=torch.from_numpy(pcf).to(device), k=k)


def ic_best_decode(inp: dict, nblocks: int, nb: int, h: int, w: int, order: int,
                   cband: tuple, tbits: int):
    """Device-resident "ic" decode of one best-mode image (inputs from
    ic_best_inputs; qb3_tpu's _decode_kernel_chunked_best): the chunk walk,
    then reconstruct -> (H, W, C) int64 carrier."""
    g = decode_chunked_best(inp["words32"], inp["starts"], inp["entry"], inp["pcf"],
                            inp["k"], nblocks, nb, tbits)
    zero = torch.zeros(nb, dtype=torch.int64, device=g.device)
    img, _ = reconstruct(g.reshape(nblocks, nb, B2), zero, h, w, nb, order, cband, tbits)
    return img


def _indexed_nreg(glens: np.ndarray, tbits: int) -> int:
    """Register-window words per "ix" group, from the sidecar's longest
    group rather than the format's worst case (qb3_tpu api._indexed_nreg)."""
    if glens.size == 0:
        return _NREG_IX[tbits]
    need = (31 + int(glens.max()) + 1 + 31) // 32 + 1
    return min(_NREG_IX[tbits], max(4, -(-need // 4) * 4))


def _fused_ix_params(glens: np.ndarray, tbits: int, tile_words32: int = 0):
    """K4's window sizes, computed once for an "ix" decode: (nreg, R), the
    register-window words per group and the words each K4 block stages.

    glens: (ngroups,) sidecar lengths of one stream, or (ntiles, ngroups)
    of a batch in the flat tile layout (tiles tile_words32 words apart)."""
    glens = np.atleast_2d(glens)
    nreg = _indexed_nreg(glens, tbits)
    ends = np.cumsum(glens.astype(np.int64), axis=1)
    tbase = np.arange(glens.shape[0], dtype=np.int64)[:, None] * (tile_words32 * 32)
    R = ix_window_R((ends - glens + tbase).reshape(-1), nreg)
    assert 4 <= nreg <= _NREG_IX[tbits] and R % 4 == 0, (nreg, R)
    return nreg, R


def walk_offsets(data: bytes, nblocks: int, nb: int, tsize: int, mode: int,
                 entry_runbits=None, entry_cf=None, start_bit: int = 0):
    """The serial walk of a payload -> (offsets.parse_offsets' result,
    "native-walk" or "python-walk"): the C++ walk where its library loads,
    else the Python one, as qb3_tpu picks.  The entry state (per-band rung
    history and CF, and the bit to start from) continues a walk, as the
    strip decoder does strip by strip."""
    from . import native

    if native.available():
        return (native.parse_offsets_native(data, nblocks, nb, tsize, mode == Mode.FTL,
                                            entry_runbits, entry_cf, start_bit),
                "native-walk")
    return (parse_offsets(data, nblocks, nb, tsize, mode, entry_runbits, entry_cf, start_bit),
            "python-walk")


def group_inputs(meta: dict, n32: int, tbits: int, device, put=None) -> dict:
    """decode_groups' per-group arguments from a walk's result, or an "ib"
    sidecar's, over a stream of n32 u32 words: each group's window word,
    bit within it, rung and K5 kind, uploaded in one (4, ngroups) int32
    copy, and cf, None unless a group is CF or CF0, else in the same copy
    (cf as u64, then the four int32 rows, viewed apart on the device); nreg
    and K7's span R computed here; put is the host-to-device copy
    (put_on(device) if None).  The window is _NREG_IX words for every
    kind and stream, the walk's and the sidecar's alike: it holds the
    longest group from any bit phase."""
    k5 = K5_KIND[meta["kind"].reshape(-1)]
    val_pos = meta["val_pos"].reshape(-1)
    n = k5.size
    # a window at or past the stream's end reads zeros wherever it starts,
    # so the word index is kept within int32
    base = np.minimum(val_pos >> 5, n32)
    nreg = _NREG_IX[tbits]
    rows = np.stack([base, val_pos & 31, meta["vrung"].reshape(-1), k5])
    cf = None
    put = put or put_on(device)
    if ((k5 == K5_KIND[KIND_CF]) | (k5 == K5_KIND[KIND_CF0])).any():
        host = np.empty(3 * n, np.int64)
        host[:n] = meta["cf"].reshape(-1).astype(np.uint64).view(np.int64)
        host[n:].view(np.int32).reshape(4, n)[:] = rows
        t = put(host)
        cf, rows = t[:n], t[n:].view(torch.int32).reshape(4, n)
    else:
        rows = put(rows.astype(np.int32))
    return dict(base=rows[0], off=rows[1], rung=rows[2], kind=rows[3], cf=cf, nreg=nreg,
                R=gather_span(base, nreg))


def _parse_best_sidecar(buf: bytes, ngroups: int):
    """The "ib" sidecar (qb3_tpu api._parse_best_sidecar): per group a u16
    bit length and a u16 meta (kind | vrung << 3 | prefix << 9), then a u16
    biased CF (cf - 2) for each CF / CF0 group -> group_inputs' dict (kind,
    val_pos, vrung, cf flat arrays, and end_pos, the lengths' total), or
    None if the sidecar is inconsistent."""
    arr = np.frombuffer(buf, dtype="<u2")
    if arr.size < 2 * ngroups:
        return None
    glens = arr[:ngroups].astype(np.int64)
    meta = arr[ngroups: 2 * ngroups].astype(np.int32)
    kind = (meta & 7).astype(np.uint8)
    iscf = (kind == KIND_CF) | (kind == KIND_CF0)
    if arr.size != 2 * ngroups + int(iscf.sum()):
        return None
    cf = np.zeros(ngroups, np.uint64)
    cf[iscf] = arr[2 * ngroups:].astype(np.uint64) + 2
    ends = np.cumsum(glens)
    return dict(kind=kind, val_pos=ends - glens + ((meta >> 9) & 127),
                vrung=((meta >> 3) & 63).astype(np.int32), cf=cf,
                end_pos=int(ends[-1]) if ngroups else 0)


def walk_inputs(meta: dict, words: np.ndarray, tbits: int, device, put=None) -> dict:
    """decode_groups' arguments from a walk's result: the padded stream
    words (padded_words) uploaded by put (put_on(device) if None), and
    group_inputs."""
    words32 = words.view(np.int32)
    put = put or put_on(device)
    return dict(words32=put(words32), **group_inputs(meta, words32.size, tbits, device, put))


class Decoder:
    """Mirror of the 3-stage decsp reader (QB3decode.cpp:130-264); the
    decode runs on `device`.

    After read_data, `decode_path` records which decode engine ran
    ("stored", "ic", "ic-best", "ix", "ib", or for streams without a usable
    sidecar "native-walk" or "python-walk", as in qb3_tpu); `failed` mirrors the
    reference's decode failure flag when read_data(partial=True) returned
    best-effort output.
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
        nblocks = ((h + B - 1) // B) * ((w + B - 1) // B)
        tbits = 8 * np.dtype(uns_dt).itemsize
        order, cband = info.order or HILBERT, tuple(info.cband)
        apply_step = info.mode != Mode.FTL
        # like qb3_tpu, RLE-wrapped fast streams (not a fast mode) take the
        # walk whatever sidecar they carry; best streams, RLE-wrapped or not,
        # their "ic" or "ib" sidecar, or the walk
        fast, best = is_fast_mode(info.mode), is_best_mode(info.mode)
        if info.index_chunked is not None and fast:
            meta = parse_ic(info.index_chunked, nblocks, nb)
            if meta is not None:
                inp = ic_inputs(padded_words(data), [meta], 0, tbits, self.device)
                img = ic_decode(inp, nblocks, nb, h, w, order, cband, apply_step, tbits)
                self.decode_path = "ic"
                return self._end_check(from_carrier(img, tbits // 8),
                                       len(data) * 8 - meta[3])
        if info.index_chunked is not None and best:
            meta = parse_ic_best(info.index_chunked, nblocks, nb)
            if meta is not None:
                img = ic_best_decode(ic_best_inputs(padded_words(data), meta, self.device),
                                     nblocks, nb, h, w, order, cband, tbits)
                self.decode_path = "ic-best"
                return self._end_check(from_carrier(img, tbits // 8),
                                       len(data) * 8 - meta[4])

        glens = None
        if info.index is not None and fast:
            cand = np.frombuffer(info.index, dtype="<u2")
            if cand.size == nblocks * nb and int(cand.astype(np.int64).sum()) < 1 << 31:
                glens = cand.astype(np.int32)
        sidecar = None
        if info.index_best is not None and best:
            sidecar = _parse_best_sidecar(info.index_best, nblocks * nb)
        meta = None
        if glens is not None:
            nreg, R = _fused_ix_params(glens, tbits)
            words32 = torch.from_numpy(padded_words(data).view(np.int32)).to(self.device)
            g = decode_indexed_narrow(words32, torch.from_numpy(glens).to(self.device),
                                      nblocks, nb, apply_step, tbits, nreg=nreg, fused=R)
            self.decode_path, end_pos = "ix", int(glens.sum())
        elif sidecar is not None:
            inp = walk_inputs(sidecar, padded_words(data), tbits, self.device)
            g = decode_groups(**inp, tbits=tbits, apply_step=apply_step)
            self.decode_path, end_pos = "ib", sidecar["end_pos"]
        else:
            meta, path = walk_offsets(data, nblocks, nb, tbits // 8, info.mode)
            inp = walk_inputs(meta, padded_words(data), tbits, self.device)
            g = decode_groups(**inp, tbits=tbits, apply_step=apply_step)
            self.decode_path, end_pos = path, meta["end_pos"]
        zero = torch.zeros(nb, dtype=torch.int64, device=g.device)
        img, _ = reconstruct(g.reshape(nblocks, nb, B2), zero, h, w, nb, order, cband, tbits)
        img = from_carrier(img, tbits // 8)
        if meta is not None and meta["failed"]:
            raise QB3DataError(f"corrupt stream (group {meta['failed_group']})", partial=img)
        return self._end_check(img, len(data) * 8 - end_pos)

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
