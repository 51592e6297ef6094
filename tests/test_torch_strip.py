"""Streaming strips of qb3_tpu_torch against qb3_tpu, on the CPU:
StripEncoder's bytes against qb3_tpu's StripEncoder and the whole-image
encode, over tests/test_strip.py's fast-mode cases and the "ix" and "ic"
sidecars (the strips stitched by stitch_words_device, K6's twin here), and
StripDecoder's rows, `failed` behaviour and exceptions against qb3_tpu's
StripDecoder, with the port's walk pinned to its C++ and to its Python walk.
Where a case lies inside what the benchmark's plain reference writes
(portbench/reference/qb3ref.py, NumPy from the format, independent of both
packages), the bytes equal its stream too, and every stream decodes, whole
and strip by strip, to the raster or to the reference's dequantized raster.
Inputs are made with numpy from a seed; the tolerance is zero.
"""

import numpy as np
import pytest

import qb3_tpu
import qb3_tpu_torch as qt
from qb3_tpu_torch import container, native
from qb3_tpu_torch.api import DT_FROM_NP
from qb3_tpu_torch.benchutil import headline_image
from qb3_tpu_torch.constants import Mode, is_best_mode
from qb3_tpu_torch.errors import QB3DataError, QB3ShapeError
from qb3_tpu_torch.ops.place_cuda import place_slabs

from portbench.reference import qb3ref

from . import corpus

CPU = "cpu"


def _nodata(img):
    img = img.copy()
    img[4: img.shape[0] - 4, 8:40] = 0  # zero runs for the RLE0 pass
    return img


def _dem(h, w, seed):
    """An int16 elevation raster: smooth land from 0 to ~4300 m and a sea at
    the type's minimum (SRTM's void and sea value) over a block of its left
    side."""
    img = corpus.natural8(h, w, 1, seed=seed).astype(np.int16) * 17
    img[h // 4:, : w // 3] = np.iinfo(np.int16).min
    return img


def _patch():
    img = np.zeros((64, 64, 1), np.uint8)
    img[20:30, 20:30] = 77
    return img


# name -> (image, mode, row pieces, strip_rows, StripEncoder keyword arguments)
ENCODE_CASES = {
    "ftl-u8-uneven": (lambda: corpus.natural8(96, 64, 3, seed=90), Mode.FTL,
                      [10, 1, 37, 16, 32], 16, {}),
    "base-h-u16": (lambda: corpus.to_type(corpus.natural8(64, 48, 1, seed=91), np.uint16, 257),
                   Mode.BASE_H, [64], 16, {}),
    "base-z-u16-odd-width-ix": (lambda: headline_image(40, 30, 2, seed=97, dtype=np.uint16),
                                Mode.BASE_Z, [13, 27], 8, {"with_index": True}),
    "quanta": (lambda: corpus.natural8(64, 64, 1, seed=93), Mode.FTL, [64], 16, {"quanta": 4}),
    "i16-quanta-away": (lambda: (corpus.natural8(48, 32, 1, seed=98).astype(np.int16) - 120),
                        Mode.FTL, [20, 28], 16, {"quanta": 7, "away": True}),
    "unaligned-height-tail": (lambda: corpus.natural8(67, 48, 1, seed=94), Mode.FTL,
                              [50, 17], 8, {}),
    "rle-h": (_patch, Mode.RLE_H, [64], 16, {}),
    "rle-h-scene-ix": (lambda: _nodata(corpus.natural8(48, 48, 2, seed=99)), Mode.RLE_H,
                       [7, 9, 32], 16, {"with_index": True}),
    "ic": (lambda: corpus.natural8(96, 64, 1, seed=95), Mode.FTL, [40, 56], 64,
           {"with_index": "ic"}),
    "ic-k2-coreband": (lambda: corpus.natural8(72, 36, 3, seed=100), Mode.BASE_H, [72], 16,
                       {"with_index": "ic", "index_chunk_blocks": 2, "coreband": (0, 0, 0)}),
    "u64-ftl-ix": (lambda: headline_image(36, 24, 1, seed=101, dtype=np.uint64), Mode.FTL,
                   [36], 8, {"with_index": True}),
    "u32-unaligned-tail": (lambda: headline_image(23, 20, 1, seed=102, dtype=np.uint32),
                           Mode.FTL, [23], 8, {}),
    # the DEM ingest: int16 with a sea at -32768, the step 4, ties toward zero
    "i16-dem-q4-cf-rle-h": (lambda: _dem(64, 48, 110), Mode.CF_RLE_H, [16, 16, 32], 16,
                            {"quanta": 4}),
    "i16-dem-200x96-cf-rle-h": (lambda: _dem(96, 200, 111), Mode.CF_RLE_H, [32, 64], 32,
                                {"quanta": 4}),
    "i16-dem-strip16-partial": (lambda: _dem(88, 40, 112), Mode.CF_RLE_H, [7, 30, 19, 24, 8],
                                16, {"quanta": 4}),
    "i16-dem-q4-cf-h": (lambda: _dem(64, 48, 113), Mode.CF_H, [64], 16, {"quanta": 4}),
}


def _stream_in_pieces(cls, img, mode, pieces, strip_rows, **kw):
    h, w, c = img.shape
    se = cls(w, h, c, DT_FROM_NP[img.dtype], mode=mode, strip_rows=strip_rows, **kw)
    pos = 0
    for p in pieces:
        se.push(img[pos: pos + p])
        pos += p
    assert pos == h
    return se.finish()


def _port_strips(*args, **kw):
    return _stream_in_pieces(qt.StripEncoder, *args, device=CPU, **kw)


def _whole(img, mode, with_index=False, quanta=1, away=False, coreband=None,
           index_chunk_blocks=0):
    h, w, c = img.shape
    e = qt.Encoder(w, h, c, DT_FROM_NP[img.dtype], device=CPU)
    e.set_mode(mode)
    e.with_index = with_index
    e.index_chunk_blocks = index_chunk_blocks
    if quanta != 1:
        e.set_quanta(quanta, away)
    if coreband is not None:
        e.set_coreband(coreband)
    return e.encode(img)


def _reference(img, mode, kw):
    """The plain reference's stream of a case, or None where the case lies
    outside what it writes: 8- and 16-bit rasters with sides multiples of 4,
    FTL, BASE_H, CF_H and their RLE0 forms, the default core bands, no
    sidecar or "ic" in chunks of its k."""
    index = kw.get("with_index") or None
    if (img.dtype not in qb3ref.DTYPES or img.shape[0] % 4 or img.shape[1] % 4
            or mode not in qb3ref.MODES.values() or index not in (None, "ic")
            or kw.get("coreband") is not None
            or kw.get("index_chunk_blocks", 0) not in (0, qb3ref.IC_K)):
        return None
    return qb3ref.encode(img, mode, index, quanta=kw.get("quanta", 1),
                         away=kw.get("away", False))


@pytest.mark.parametrize("name", list(ENCODE_CASES))
def test_strip_encode_equals_qb3_tpu_and_whole(name):
    make, mode, pieces, strip_rows, kw = ENCODE_CASES[name]
    img = make()
    got = _port_strips(img, mode, pieces, strip_rows, **kw)
    assert got == _stream_in_pieces(qb3_tpu.StripEncoder, img, mode, pieces, strip_rows, **kw)
    assert got == _whole(img, mode, **kw)
    ref = _reference(img, mode, kw)
    assert ref is not None or not name.startswith("i16-dem")
    assert ref is None or got == ref
    info = container.parse_headers(got)
    assert info.mode == mode and info.mode != Mode.STORED
    index = kw.get("with_index")
    assert (info.index is not None) == (index is True)
    assert (info.index_chunked is not None) == (index == "ic")
    q, away = kw.get("quanta", 1), kw.get("away", False)
    want = img if q == 1 else qb3ref.dequantize(qb3ref.quantize(img, q, away), q)
    outs = [qt.decode(got, device=CPU)[0]]
    if img.shape[1] % 4 == 0:  # StripDecoder, as qb3_tpu's, reads no ragged width
        sd = qt.StripDecoder(got, strip_rows=strip_rows, device=CPU)
        rows = []
        while (r := sd.read()) is not None:
            rows.append(r)
        outs.append(np.concatenate(rows))
    for out in outs:
        assert out.dtype == img.dtype
        np.testing.assert_array_equal(out, want)
        if np.issubdtype(img.dtype, np.signedinteger):  # the sea comes back exact
            sea = img == np.iinfo(img.dtype).min
            np.testing.assert_array_equal(out[sea], img[sea])


def test_strip_encode_stitches_once_through_k6_twin(monkeypatch):
    """finish() stitches every strip in one stitch_words_device call; on the
    CPU that runs K6's twin, so the kernel's counter does not move."""
    from qb3_tpu_torch import strip

    calls = []
    real = strip.stitch_words_device
    monkeypatch.setattr(strip, "stitch_words_device",
                        lambda w, t, n: calls.append(len(t)) or real(w, t, n))
    before = place_slabs.launches
    img = corpus.natural8(40, 32, 3, seed=103)
    assert _port_strips(img, Mode.FTL, [8] * 5, 8) == qt.encode(img, device=CPU)
    assert calls == [5] and place_slabs.launches == before


def test_bounded_memory():
    """The pending buffer never holds more than ~2 strips of rows; each
    strip's words are kept trimmed to its bits."""
    img = corpus.natural8(256, 32, 1, seed=96)
    se = qt.StripEncoder(32, 256, 1, DT_FROM_NP[img.dtype], strip_rows=16, device=CPU)
    worst = 0
    for y in range(0, 256, 8):
        se.push(img[y: y + 8])
        worst = max(worst, se._pending.shape[0])
    assert all(p.numel() == -(-t // 32) for p, t in zip(se._parts, se._totals))
    s = se.finish()
    assert worst <= 32, worst
    assert s == _whole(img, Mode.FTL)


def test_errors():
    with pytest.raises(QB3ShapeError):
        qt.StripEncoder(3, 64, 1, 0, device=CPU)
    with pytest.raises(QB3ShapeError):
        qt.StripEncoder(32, 64, 1, 0, strip_rows=6, device=CPU)
    se = qt.StripEncoder(32, 64, 1, 0, device=CPU)
    with pytest.raises(QB3ShapeError):
        se.push(np.zeros((65, 32, 1), np.uint8))
    with pytest.raises(QB3ShapeError):
        se.push(np.zeros((10, 32, 1), np.uint16))
    se.push(np.zeros((10, 32, 1), np.uint8))
    with pytest.raises(QB3ShapeError):
        se.finish()
    se.push(np.zeros((54, 32, 1), np.uint8))
    se.finish()
    with pytest.raises(QB3ShapeError):
        se.finish()
    with pytest.raises(QB3ShapeError):
        qt.StripDecoder(qt.encode(corpus.natural8(8, 8, 1, seed=1), device=CPU), strip_rows=10,
                        device=CPU)


@pytest.mark.parametrize("mode", [Mode.CF_H, Mode.CF_RLE_H, Mode.CF])
def test_best_modes_raise(mode):
    """The best modes, which raised NotImplementedError before they were
    ported: StripEncoder's bytes equal qb3_tpu's StripEncoder's and the
    whole-image encode, and StripDecoder reads qb3_tpu's stream to the
    raster (tests/test_torch_best.py holds the sidecars)."""
    img = corpus.natural8(32, 32, 1, seed=2) // 3 * 3
    stream = _port_strips(img, mode, [12, 20], 16)
    assert stream == _stream_in_pieces(qb3_tpu.StripEncoder, img, mode, [12, 20], 16)
    assert stream == qb3_tpu.encode(img, mode=mode)
    assert is_best_mode(container.parse_headers(stream).mode)
    sd = qt.StripDecoder(stream, strip_rows=16, device=CPU)
    rows = []
    while (r := sd.read(10)) is not None:
        rows.append(r)
    np.testing.assert_array_equal(np.concatenate(rows), img)


# ------------------------------------------------------------ StripDecoder

# name -> (stream, strip_rows, rows per read)
DECODE_CASES = {
    "ftl": (lambda: qb3_tpu.encode(corpus.natural8(96, 48, 3, seed=160), mode=Mode.FTL), 64, 20),
    "base-h": (lambda: qb3_tpu.encode(corpus.natural8(96, 48, 3, seed=160), mode=Mode.BASE_H),
               64, 20),
    "unaligned-height": (lambda: qb3_tpu.encode(corpus.natural8(70, 32, 1, seed=161)), 16, 7),
    "quanta-u16": (lambda: qb3_tpu.encode(corpus.to_type(
        corpus.natural8(64, 32, 1, seed=162), np.uint16, 257), quanta=5), 64, None),
    "rle": (lambda: qb3_tpu.encode(np.pad(np.full((4, 4, 1), 9, np.uint8),
                                          ((4, 24), (4, 24), (0, 0))), mode=Mode.RLE_H), 64, 8),
    "stored": (lambda: qb3_tpu.encode(corpus.natural8(3, 3, 1, seed=163)), 64, 2),
    "strip-encoded": (lambda: _port_strips(corpus.natural8(128, 40, 2, seed=164), Mode.FTL,
                                           [16] * 8, 64), 64, 16),
    "tall-ftl-ix": (lambda: qb3_tpu.encode(corpus.natural8(96, 64, 3, seed=5), index=True),
                    16, None),
    "tall-ftl-ic": (lambda: qb3_tpu.encode(corpus.natural8(96, 64, 3, seed=5), index="ic"),
                    16, None),
    "tall-ftl": (lambda: qb3_tpu.encode(corpus.natural8(96, 64, 3, seed=5)), 16, None),
    "tall-base-h-ix": (lambda: qb3_tpu.encode(corpus.natural8(96, 64, 3, seed=5),
                                              mode=Mode.BASE_H, index=True), 16, None),
    "u16-unaligned-ix": (lambda: qb3_tpu.encode(
        corpus.natural8(70, 64, 2, seed=6).astype(np.uint16) * np.uint16(257), index=True),
        24, None),
    "quanta-ix": (lambda: qb3_tpu.encode(corpus.natural8(64, 64, 1, seed=8), quanta=4,
                                         index=True), 16, None),
    "rle-ix": (lambda: qb3_tpu.encode(np.pad(np.full((10, 20, 1), 3, np.uint8),
                                             ((10, 44), (10, 34), (0, 0))), mode=Mode.RLE_H,
                                      index=True), 16, None),
    "u64-base-z": (lambda: qb3_tpu.encode(headline_image(44, 20, 2, seed=104, dtype=np.uint64),
                                          mode=Mode.BASE_Z), 16, 12),
}


def _read_all(dec, chunk):
    """Every read's rows, then the exception a read raised (or None)."""
    rows = []
    try:
        while (r := dec.read(chunk)) is not None:
            rows.append(r)
    except (QB3DataError, qb3_tpu.QB3DataError) as e:
        return rows, e
    return rows, None


def _decode(cls, stream, strip_rows, chunk, **kw):
    dec = cls(stream, strip_rows=strip_rows, **kw)
    return dec, _read_all(dec, chunk)


_THEIRS = {}


def _theirs(name, stream, strip_rows, chunk):
    """qb3_tpu's reads of one case, made once per process."""
    if name not in _THEIRS:
        _THEIRS[name] = _decode(qb3_tpu.StripDecoder, stream, strip_rows, chunk)[1]
    return _THEIRS[name]


def _pin(walk, monkeypatch):
    if walk == "python":
        monkeypatch.setattr(native, "available", lambda: False)
    elif not native.available():
        pytest.skip("no C++ compiler: the native walk does not build")


@pytest.mark.parametrize("walk", ["native", "python"])
@pytest.mark.parametrize("name", list(DECODE_CASES))
def test_strip_decode_equals_qb3_tpu(name, walk, monkeypatch):
    """The same rows, read by read, as qb3_tpu's StripDecoder, and the whole
    decode's array."""
    _pin(walk, monkeypatch)
    make, strip_rows, chunk = DECODE_CASES[name]
    stream = make()
    dec, (rows, err) = _decode(qt.StripDecoder, stream, strip_rows, chunk, device=CPU)
    want, werr = _theirs(name, stream, strip_rows, chunk)
    assert err is None and werr is None
    assert len(rows) == len(want)
    for got, w in zip(rows, want):
        assert got.dtype == w.dtype
        np.testing.assert_array_equal(got, w)
    np.testing.assert_array_equal(np.concatenate(rows), qt.decode(stream, device=CPU)[0])
    info = container.parse_headers(stream)
    whole = info.mode == Mode.STORED or min(info.xsize, info.ysize) < 4
    assert dec.decode_path == ("stored" if whole else f"{walk}-walk")


def _flip(stream, frac):
    info = container.parse_headers(stream)
    at = info.data_offset + (len(stream) - info.data_offset) * frac // 100
    return stream[:at] + bytes([stream[at] ^ (1 << (at % 8))]) + stream[at + 1:]


# name -> damaged stream (no sidecar: the strips are walked)
DAMAGED = {
    "ftl-flip-40": lambda: _flip(qb3_tpu.encode(headline_image(64, 48, 3, seed=105)), 40),
    "ftl-flip-85": lambda: _flip(qb3_tpu.encode(headline_image(64, 48, 3, seed=105)), 85),
    "u16-base-h-flip-60": lambda: _flip(qb3_tpu.encode(
        headline_image(48, 40, 1, seed=106, dtype=np.uint16), mode=Mode.BASE_H), 60),
    "garbage": lambda: qb3_tpu.encode(headline_image(64, 48, 3, seed=105)) + bytes(range(9)),
    "truncated": lambda: qb3_tpu.encode(headline_image(64, 48, 3, seed=105))[:-40],
}


@pytest.mark.parametrize("walk", ["native", "python"])
@pytest.mark.parametrize("name", list(DAMAGED))
def test_damaged_strip_decode_equals_qb3_tpu(name, walk, monkeypatch):
    """A damaged stream: the same rows before the failing strip, and the
    same QB3DataError with the same partial array, or the same rows where
    qb3_tpu reads through (truncated input decodes as zeros)."""
    _pin(walk, monkeypatch)
    stream = DAMAGED[name]()
    _, (rows, err) = _decode(qt.StripDecoder, stream, 16, None, device=CPU)
    want, werr = _theirs(f"damaged-{name}", stream, 16, None)
    assert len(rows) == len(want)
    for got, w in zip(rows, want):
        np.testing.assert_array_equal(got, w)
    assert (err is None) == (werr is None)
    if name in ("ftl-flip-85", "garbage"):
        assert err is not None  # the final strip's walk ends with leftover bits
    if err is not None:
        assert str(err) == str(werr)
        np.testing.assert_array_equal(err.partial, werr.partial)
