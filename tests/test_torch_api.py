"""qb3_tpu_torch's public API against qb3_tpu, on the CPU: encoded bytes,
decoded arrays, carried band state, the batch path, and the headline
stream's sha256.  The tolerance is zero: bytes and arrays are equal."""

import hashlib

import numpy as np
import pytest

import qb3_tpu
import qb3_tpu_torch as qt
from qb3_tpu.api import Encoder as JEncoder
from qb3_tpu.api import dequantize, quantize
from qb3_tpu.batch import decode_tiles as j_decode_tiles
from qb3_tpu.batch import encode_tiles as j_encode_tiles
from qb3_tpu_torch import container
from qb3_tpu_torch.api import DT_FROM_NP
from qb3_tpu_torch.benchutil import HEADLINE_SHA256, headline_image
from qb3_tpu_torch.constants import Mode

from . import corpus

CPU = "cpu"


def stream_shape(img):
    return img.shape if img.ndim == 3 else (*img.shape, 1)


def _rle_blob():
    img = np.zeros((64, 64, 1), np.uint8)
    img[10:20, 10:20] = 200
    return img


# name -> (image, encode keyword arguments)
CORPUS = {
    "ftl-rgb": (lambda: corpus.natural8(40, 36, 3, seed=1), {}),
    "base-h-unaligned": (lambda: corpus.natural8(37, 29, 1, seed=2), {"mode": Mode.BASE_H}),
    "base-z": (lambda: corpus.natural8(32, 32, 2, seed=3), {"mode": Mode.BASE_Z}),
    "stored-noise": (lambda: corpus.random_noise(24, 24, 1, np.uint8), {}),
    "tiny": (lambda: corpus.natural8(3, 3, 1, seed=4), {}),
    "one-pixel-wide": (lambda: corpus.natural8(29, 1, 1, seed=5), {}),
    "short-wide": (lambda: corpus.natural8(2, 37, 2, seed=6), {}),
    "quanta-u8": (lambda: corpus.natural8(24, 28, 1, seed=7), {"quanta": 4}),
    "quanta-i16-away": (lambda: (corpus.natural8(24, 24, 1, seed=8).astype(np.int16)
                                 - 120).astype(np.int16), {"quanta": 7, "away": True}),
    "rle-h": (_rle_blob, {"mode": Mode.RLE_H}),
    "signed-i16": (lambda: (corpus.natural8(28, 24, 1, seed=9).astype(np.int16)
                            - 100).astype(np.int16), {}),
    "u16-base": (lambda: corpus.to_type(corpus.natural8(24, 32, 1, seed=10),
                                        np.uint16, 257), {"mode": Mode.BASE_H}),
    "u32": (lambda: corpus.to_type(corpus.natural8(20, 20, 1, seed=11), np.uint32, 65537), {}),
    "i64": (lambda: (corpus.natural8(16, 20, 1, seed=12).astype(np.int64)
                     * -(1 << 30)).astype(np.int64), {}),
    "coreband": (lambda: corpus.natural8(24, 24, 3, seed=13), {"coreband": [1, 1, 1]}),
}


@pytest.mark.parametrize("index", [False, "ic"])
@pytest.mark.parametrize("name", list(CORPUS))
def test_encode_bytes_equal(name, index):
    make, kw = CORPUS[name]
    img = make()
    stream = qt.encode(img, index=index, device=CPU, **kw)
    assert stream == qb3_tpu.encode(img, index=index, **kw)
    if index == "ic" and container.parse_headers(stream).mode in (
            Mode.FTL, Mode.BASE_H, Mode.BASE_Z):
        # the port decodes qb3_tpu's "ic" streams to the arrays qb3_tpu
        # decodes them to: the image, dequantized where quantized (its
        # decoder itself runs on damaged streams below, one compile)
        want = img.reshape(stream_shape(img))
        if "quanta" in kw:
            want = dequantize(quantize(want, kw["quanta"], kw.get("away", False)),
                              kw["quanta"])
        ours = qt.Decoder(stream, device=CPU)
        np.testing.assert_array_equal(ours.read_data(), want)
        assert ours.decode_path == "ic"


def test_stride_encode_and_decode():
    img = corpus.natural8(24, 20, 2, seed=14)
    buf = np.zeros((24, 50), np.uint8)
    buf[:, :40] = img.reshape(24, 40)
    streams = []
    for enc in (qt.Encoder(20, 24, 2, DT_FROM_NP[img.dtype], device=CPU),
                JEncoder(20, 24, 2, DT_FROM_NP[img.dtype])):
        enc.set_stride(50)
        enc.with_index = "ic"
        streams.append(enc.encode(buf))
    assert streams[0] == streams[1]
    dec = qt.Decoder(streams[0], device=CPU)
    dec.set_stride(50)
    np.testing.assert_array_equal(dec.read_data().reshape(24, 50)[:, :40], buf[:, :40])


@pytest.mark.parametrize("k", [1, 3])
def test_chunk_size_option(k):
    img = corpus.natural8(32, 28, 3, seed=19)
    streams = []
    for enc in (qt.Encoder(28, 32, 3, DT_FROM_NP[img.dtype], device=CPU),
                JEncoder(28, 32, 3, DT_FROM_NP[img.dtype])):
        enc.with_index = "ic"
        enc.index_chunk_blocks = k
        streams.append(enc.encode(img))
    assert streams[0] == streams[1]
    np.testing.assert_array_equal(qt.decode(streams[0], device=CPU)[0], img)


def test_band_state_carries_across_images():
    """A port Encoder given qb3_tpu's band state after one image encodes the
    next image to the same bytes."""
    first = corpus.natural8(32, 28, 3, seed=15)
    second = corpus.natural8(32, 28, 3, seed=16)
    jenc = JEncoder(28, 32, 3, DT_FROM_NP[first.dtype])
    jenc.with_index = "ic"
    jenc.encode(first)
    enc = qt.Encoder(28, 32, 3, DT_FROM_NP[first.dtype], device=CPU)
    enc.with_index = "ic"
    enc.band_prev = jenc.band_prev.copy()
    enc.band_runbits = jenc.band_runbits.copy()
    assert enc.encode(second) == jenc.encode(second)
    np.testing.assert_array_equal(enc.band_prev, jenc.band_prev)
    np.testing.assert_array_equal(enc.band_runbits, jenc.band_runbits)


@pytest.mark.parametrize("damage", ["extra-bytes", "truncated", "bit-flip"])
def test_damaged_ic_stream_decodes_like_qb3_tpu(damage):
    stream = qb3_tpu.encode(corpus.natural8(40, 32, 2, seed=17), index="ic")
    if damage == "extra-bytes":
        stream += b"\x5a\xa5"
    elif damage == "truncated":
        stream = stream[:-40]
    else:
        stream = stream[:-300] + bytes([stream[-300] ^ 0x10]) + stream[-299:]
    outs = []
    for dec in (qt.Decoder(stream, device=CPU), qb3_tpu.Decoder(stream)):
        outs.append((dec.read_data(partial=True), dec.failed))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    assert outs[0][1] == outs[1][1] == (damage == "extra-bytes")


@pytest.mark.parametrize("dtype,mode", [(np.uint8, Mode.FTL), (np.uint16, Mode.BASE_Z)])
def test_tiles_equal(dtype, mode):
    tiles = np.stack([headline_image(24, 20, 3, seed=s, dtype=dtype) for s in range(3)])
    streams = qt.encode_tiles(tiles, mode=mode, index="ic", device=CPU)
    assert streams == j_encode_tiles(tiles, mode=mode, index="ic")
    assert qt.encode_tiles(tiles, mode=mode, device=CPU) == j_encode_tiles(tiles, mode=mode)
    out = qt.decode_tiles(streams, device=CPU)
    np.testing.assert_array_equal(out, j_decode_tiles(streams))
    np.testing.assert_array_equal(out, tiles)


def test_not_ported_paths_raise():
    """The paths that raised NotImplementedError before best mode was
    ported now give qb3_tpu's bytes and arrays: the best encode with no
    sidecar, "ib" and "ic", and the decode of a best stream's "ic" sidecar;
    streams without a sidecar, FTL and best (CF_H) alike, decode (the serial
    walk) to qb3_tpu's arrays."""
    img = corpus.natural8(16, 16, 1, seed=18) // 3 * 3
    for stream in (qb3_tpu.encode(img), qb3_tpu.encode(img, mode=Mode.CF_H)):
        np.testing.assert_array_equal(qt.decode(stream, device=CPU)[0],
                                      qb3_tpu.decode(stream)[0])
    for index in (False, True, "ic"):
        stream = qb3_tpu.encode(img, mode=Mode.CF_H, index=index)
        assert qt.encode(img, mode=Mode.CF_H, index=index, device=CPU) == stream
    assert container.parse_headers(stream).index_chunked is not None
    dec = qt.Decoder(stream, device=CPU)
    np.testing.assert_array_equal(dec.read_data(), qb3_tpu.decode(stream)[0])
    assert dec.decode_path == "ic-best"


def test_headline_sha256():
    """The constant chip_smoke.py checks on the card, re-derived from both
    packages."""
    img = headline_image()
    assert img.shape == (512, 512, 3) and img.dtype == np.uint8
    stream = qb3_tpu.encode(img, index="ic")
    assert hashlib.sha256(stream).hexdigest() == HEADLINE_SHA256
    assert qt.encode(img, index="ic", device=CPU) == stream
