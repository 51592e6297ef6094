"""The benchmark's plain reference (portbench/reference/qb3ref.py) on the CPU.

The pins were computed with the JAX package and are re-derived here at the
benchmark's own sizes: the headline raster's FTL "ic" stream, the Landsat
sample's decoded raster and its CF_H stream; and at small sizes the streams
of signed rasters (signed_raster), lossless and quantized, in the RLE0
modes too.  Round trips and equality with the port's CPU path (its kernels'
plain twins) cover the other group kinds, shapes and band counts, and the
cross of i8 / i16, steps 1, 2, 3, 4 and 10 with and without ties away from
zero, and FTL, CF_H, RLE_H and CF_RLE_H, at small sizes.

    python -m pytest -q portbench/tests/test_portbench_reference.py
"""

from __future__ import annotations

import hashlib
import os

import numpy as np
import pytest

from portbench.rasters import headline, landsat
from portbench.reference import pins, qb3ref

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


@pytest.fixture(scope="module")
def sample() -> bytes:
    with open(os.path.join(ROOT, pins.LANDSAT_SAMPLE), "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def landsat_raster(sample) -> np.ndarray:
    return qb3ref.decode(sample)


def test_headline_ftl_ic_pin():
    img = headline.headline_image()
    assert sha(qb3ref.encode(img, qb3ref.FTL, index="ic")) == pins.HEADLINE_SHA256


def test_landsat_decode_pin(landsat_raster):
    assert landsat_raster.shape == (512, 512, 8) and landsat_raster.dtype == np.uint16
    assert sha(landsat_raster.tobytes()) == pins.LANDSAT_SHA256


def test_landsat_cfh_encode_pin(landsat_raster, sample):
    stream = qb3ref.encode(landsat_raster, qb3ref.CF_H)
    assert sha(stream) == pins.LANDSAT_ENCODE_SHA256
    assert stream == sample


def test_landsat_cache(tmp_path, monkeypatch, landsat_raster):
    """The raster maker decodes the sample once, keeps it, and reads the
    kept copy back against the pin."""
    monkeypatch.setattr(landsat, "CACHE", str(tmp_path))
    monkeypatch.chdir(ROOT)
    assert np.array_equal(landsat.raster(), landsat_raster)
    assert os.path.exists(tmp_path / "landsat8.npy")
    assert np.array_equal(landsat.raster(), landsat_raster)


def _rasters(dtype, h, w, nb, seed):
    """Seeded rasters that reach every group kind: smooth, noisy, flat,
    multiples of a common factor, a few distinct values a group."""
    rng = np.random.default_rng(seed)
    top = np.iinfo(dtype).max
    smooth = headline.headline_image(h, w, nb, seed, dtype)
    noise = rng.integers(0, top, (h, w, nb), dtype=np.int64, endpoint=True).astype(dtype)
    flat = np.full((h, w, nb), rng.integers(0, top), dtype)
    factor = (rng.integers(0, top // 12, (h, w, nb)) * 12).astype(dtype)
    levels = rng.choice(rng.integers(0, top, 5), (h, w, nb)).astype(dtype)
    bits = (rng.integers(0, 2, (h, w, nb)) + smooth // 64 * 64).astype(dtype)
    return dict(smooth=smooth, noise=noise, flat=flat, factor=factor, levels=levels, bits=bits)


def signed_raster(kind: str, dtype, h: int, w: int, nb: int, seed: int) -> np.ndarray:
    """A seeded signed raster: "dem", a smooth field with negative values, a
    sea at the type's minimum (SRTM's nodata) over the left quarter and four
    rows of zeros across the middle; "noise", any value of the type."""
    dtype = np.dtype(dtype)
    lim = np.iinfo(dtype)
    if kind == "noise":
        rng = np.random.default_rng(seed)
        return rng.integers(lim.min, lim.max, (h, w, nb), endpoint=True).astype(dtype)
    v = headline.headline_image(h, w, nb, seed, np.uint8).astype(np.int64) - 120
    v *= 1 if dtype.itemsize == 1 else 53
    v[:, : w // 4] = lim.min
    v[h // 2: h // 2 + 4] = 0
    return np.clip(v, lim.min, lim.max).astype(dtype)


def _signed_rasters(dtype, h, w, nb, seed):
    """_rasters' kinds read as the signed type (negative values, the type's
    minimum), and a "dem" signed_raster."""
    twin = np.dtype(dtype).str.replace("i", "u")
    out = {k: v.view(dtype) for k, v in _rasters(np.dtype(twin), h, w, nb, seed).items()}
    out["dem"] = signed_raster("dem", dtype, h, w, nb, seed)
    return out


SHAPES = ((16, 16, 1), (24, 40, 3), (32, 16, 8))
CASES = [(dt, shape) for dt in (np.uint8, np.uint16) for shape in SHAPES]
# (quanta, away): lossless, then each step with ties toward and away from zero
QUANTA = [(1, False)] + [(q, away) for q in (2, 3, 4, 10) for away in (False, True)]
SIGNED = [(dt, shape, qb3ref.MODES[mode], None, q, away)
          for dt in (np.int8, np.int16) for shape in SHAPES
          for mode in ("FTL", "CF_H", "RLE_H", "CF_RLE_H") for q, away in QUANTA]


def _ids(x):
    return getattr(x, "__name__", str(x))


def _expands_past_raw(stream: bytes) -> bool:
    """Whether an RLE0 stream's payload, expanded, passes the raster's raw
    size, which the decoder's guard refuses (QB3decode.cpp:399-404); the
    encoder writes such a stream where RLE0 shrinks a payload larger than
    the raster.  Counted by a serial walk of the grammar."""
    i = qb3ref.parse_header(stream)
    if i["mode"] not in qb3ref.RLE_BASE:
        return False
    data, pos, size = stream[i["offset"]:], 0, 0
    while pos < len(data):
        if pos < len(data) - 2 and data[pos] == data[pos + 1] == 0xFF:
            size += 2 if data[pos + 2] == 0xFF else 4 + data[pos + 2]
            pos += 3
        else:
            size += 1
            pos += 1
    return size > i["h"] * i["w"] * i["nb"] * np.dtype(qb3ref.NP_DTYPES[i["dtype"]]).itemsize


def _expected(img, stream, quanta, away):
    """What the stream decodes to: the raster where it is lossless or
    stored raw, else the raster quantized and multiplied back; and check
    that this lies within half a step of the raster."""
    if quanta < 2 or qb3ref.parse_header(stream)["mode"] == qb3ref.STORED:
        return img
    want = qb3ref.dequantize(qb3ref.quantize(img, quanta, away), quanta)
    assert (2 * np.abs(want.astype(np.int64) - img) <= quanta).all()
    return want


@pytest.mark.parametrize("dtype,shape,mode,index,quanta,away",
                         [c + (m, i, 1, False) for c in CASES
                          for m, i in [(qb3ref.FTL, "ic"), (qb3ref.FTL, None),
                                       (qb3ref.BASE_H, None), (qb3ref.CF_H, None)]] + SIGNED,
                         ids=_ids)
def test_round_trip(dtype, shape, mode, index, quanta, away):
    """Each raster decodes from its stream to itself, or at a step q to its
    quantized values multiplied back, within q / 2 of it; a stream the
    decoder's size guard refuses is refused."""
    make = _rasters if np.dtype(dtype).kind == "u" else _signed_rasters
    for name, img in make(dtype, *shape, seed=sum(shape) + mode).items():
        stream = qb3ref.encode(img, mode, index, quanta=quanta, away=away)
        if _expands_past_raw(stream):
            with pytest.raises(ValueError, match="RLE0"):
                qb3ref.decode(stream)
            continue
        out = qb3ref.decode(stream)
        assert out.dtype == img.dtype, name
        assert np.array_equal(out, _expected(img, stream, quanta, away)), name


@pytest.mark.parametrize("dtype,shape,mode,index,quanta,away",
                         [c + (m, i, 1, False) for c in CASES
                          for m, i in [(qb3ref.FTL, "ic"), (qb3ref.CF_H, None)]] + SIGNED,
                         ids=_ids)
def test_matches_port_on_cpu(dtype, shape, mode, index, quanta, away):
    """Byte for byte the port's streams (its CPU path) at small sizes, and
    the port's streams decode by the reference to their rasters (at a
    step, to the quantized values multiplied back), or are refused by both
    decoders' size guard."""
    q = pytest.importorskip("qb3_tpu_torch")
    make = _rasters if np.dtype(dtype).kind == "u" else _signed_rasters
    for name, img in make(dtype, *shape, seed=sum(shape) + 7 * mode).items():
        port = q.encode(img, mode=mode, quanta=quanta, away=away, index=index or False,
                        device="cpu")
        assert qb3ref.encode(img, mode, index, quanta=quanta, away=away) == port, name
        if _expands_past_raw(port):
            with pytest.raises(ValueError, match="RLE0"):
                qb3ref.decode(port)
            with pytest.raises(ValueError, match="RLE"):
                q.decode(port, device="cpu")
            continue
        assert np.array_equal(qb3ref.decode(port), _expected(img, port, quanta, away)), name


@pytest.mark.parametrize("case", sorted(pins.SIGNED), ids=lambda c: "-".join(map(str, c)))
def test_signed_pins(case):
    """The streams of small signed rasters, lossless and quantized, in the
    RLE0 modes with the pass taken and refused, against qb3_tpu's sha256s."""
    kind, dtype, shape, seed, mode, quanta, away, rle = case
    img = signed_raster(kind, dtype, *shape, seed)
    stream = qb3ref.encode(img, qb3ref.MODES[mode], quanta=quanta, away=away)
    assert sha(stream) == pins.SIGNED[case]
    if rle:
        assert (qb3ref.parse_header(stream)["mode"] == qb3ref.MODES[mode]) == (rle == "taken")


def test_rle0_grammar():
    """The RLE0 pass on hand-made payloads: pairs of 0xff, zero runs in
    pieces of 258, a zero run behind a lone 0xff, the last two bytes."""
    cases = {
        b"\x01\xff\xff\x02": b"\x01\xff\xff\xff\x02",
        b"\x05" + bytes(300) + b"\x07\x08": b"\x05\xff\xff\xfe\xff\xff\x26\x07\x08",
        b"\xff" + bytes(5) + b"\x09\x09": b"\xff\x00\xff\xff\x00\x09\x09",
        b"\x01\x02\xff\xff": b"\x01\x02\xff\xff",
        b"\x01" + bytes(3) + b"\x02\x03": b"\x01" + bytes(3) + b"\x02\x03",
    }
    for raw, packed in cases.items():
        assert qb3ref.rle0_encode(raw) == packed, raw
        assert qb3ref.rle0_decode(packed, len(raw)) == raw, raw
    with pytest.raises(ValueError):
        qb3ref.rle0_decode(b"\x05\xff\xff\xfe\x07\x08", 100)


def test_slices_carry_the_band_state(monkeypatch):
    """The encoder's slices of block rows give the bytes of one slice."""
    img = signed_raster("dem", np.int16, 64, 32, 3, 11)
    for mode, index in [(qb3ref.FTL, "ic"), (qb3ref.BASE_H, None), (qb3ref.CF_RLE_H, None)]:
        whole = qb3ref.encode(img, mode, index, quanta=4)
        monkeypatch.setattr(qb3ref, "SLICE_GROUPS", 5)  # one block row a slice
        assert qb3ref.encode(img, mode, index, quanta=4) == whole
        monkeypatch.undo()


def test_codes_are_prefix_free():
    """Each rung's group and single codes (with the middle swaps) decode
    back through the reference's tables."""
    for r in range(1, 8):
        v = np.arange(1 << (r + 1))
        for group in (True, False):
            code, ln = qb3ref.group_code(v, r) if group else qb3ref.single_code(v, r)
            table = qb3ref._DEC_GROUP[r] if group else qb3ref._DEC_SINGLE[r]
            for x, c, n in zip(v, code, ln):
                assert table[int(c)] == (int(n), int(x))
