"""16-bit RGB photographs through qb3_tpu_torch's strip encoder in FTL, on
the CPU: the route of rgb16-photo-ingest (portbench) at small sizes.

Seeded u16 x 3 images whose sides are multiples of 4 (portbench's
photo16 maker, and a smooth natural image widened to 16 bits), pushed into
16-row strips with a short last strip: StripEncoder's stream against the
benchmark's plain reference (portbench/reference/qb3ref.py), the one-shot
encode and qb3_tpu's; its decode back to the source; each strip taken
through api.fused_encode (the image-layout phase A and K8's twin); the
tracer's encode.phase_a and encode.pack inside each strip.encode and
strip.bytes inside strip.finish, with the stream unchanged by them; and
the bit offsets of the strips' stitch at a scene's bit totals, past 2^31.
The tolerance is zero.
"""

import numpy as np
import pytest

import qb3_tpu
import qb3_tpu_torch as qt
from qb3_tpu_torch import api, container, profiling, strip
from qb3_tpu_torch.constants import DType, Mode
from qb3_tpu_torch.stitch import stitch_runs

from portbench.rasters import photo16
from portbench.reference import qb3ref

from . import corpus

CPU = "cpu"
STRIP_ROWS = 16


def _natural16(h, w, seed):
    """A smooth natural image widened to 16 bits, with a low-bit noise."""
    img = corpus.natural8(h, w, 3, seed=seed).astype(np.uint16) * 257
    rng = np.random.default_rng(seed)
    return img ^ rng.integers(0, 64, img.shape, dtype=np.uint16)


# name -> (image, the row pieces pushed)
CASES = {
    "photo-64x96": (lambda: photo16.image(64, 96, np.random.default_rng(2**33 + 61)),
                    [16] * 4),
    "photo-100x96-short-last": (lambda: photo16.image(100, 96, np.random.default_rng(62)),
                                [16] * 6 + [4]),
    "natural-64x96-uneven": (lambda: _natural16(64, 96, 63), [5, 27, 16, 16]),
}


@pytest.fixture(autouse=True)
def tracer_off():
    """Each test starts with the tracer off and its ring empty, and leaves
    it off."""
    profiling.disable()
    profiling.enable()
    profiling.disable()
    yield
    profiling.disable()


def _strips(img, pieces):
    h, w, c = img.shape
    se = strip.StripEncoder(w, h, c, DType.U16, mode=Mode.FTL, strip_rows=STRIP_ROWS,
                            device=CPU)
    y = 0
    for n in pieces:
        se.push(img[y: y + n])
        y += n
    assert y == h
    return se.finish()


def _strip_heights(pieces):
    """The rows of each strip the pushes of `pieces` encode: every whole
    STRIP_ROWS rows a push completes, as one strip, and at the last push
    the rest."""
    h, seen, done, out = sum(pieces), 0, 0, []
    for n in pieces:
        seen += n
        take = seen - done if seen == h else (seen - done) // STRIP_ROWS * STRIP_ROWS
        if take:
            out.append(take)
            done += take
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_strip_stream_equals_the_reference_and_the_one_shot_encode(name):
    make, pieces = CASES[name]
    img = make()
    assert img.dtype == np.uint16 and img.shape[2] == 3 and img.shape[0] % 4 == 0
    stream = _strips(img, pieces)
    assert stream == qb3ref.encode(img, qb3ref.FTL)
    assert stream == qt.encode(img, device=CPU) == qb3_tpu.encode(img)
    assert container.parse_headers(stream).mode == Mode.FTL  # not stored


@pytest.mark.parametrize("name", list(CASES))
def test_strip_stream_decodes_to_the_source(name):
    make, pieces = CASES[name]
    img = make()
    stream = _strips(img, pieces)
    out, info = qt.decode(stream, device=CPU)
    assert out.dtype == np.uint16 and np.array_equal(out, img)
    sd = strip.StripDecoder(stream, strip_rows=STRIP_ROWS, device=CPU)
    rows = []
    while (r := sd.read(24)) is not None:
        rows.append(r)
    assert np.array_equal(np.concatenate(rows), img)


@pytest.mark.parametrize("name", list(CASES))
def test_each_strip_takes_the_image_layout_encode(name, monkeypatch):
    """Every strip of a u16 image whose sides are multiples of 4 goes through
    api.fused_encode (phase_a_image, then K8's twin), none through the block
    encode."""
    make, pieces = CASES[name]
    img = make()
    seen = {"fused_encode": [], "fast_encode": []}
    for fn_name, calls in seen.items():
        fn = getattr(api, fn_name)

        def spy(x, *a, _fn=fn, _calls=calls, **kw):
            _calls.append(tuple(x.shape))
            return _fn(x, *a, **kw)

        monkeypatch.setattr(api, fn_name, spy)
    _strips(img, pieces)
    w = img.shape[1]
    assert seen == {"fused_encode": [(r, w, 3) for r in _strip_heights(pieces)],
                    "fast_encode": []}


@pytest.mark.parametrize("name", list(CASES))
def test_strip_spans_time_phase_a_pack_and_bytes_without_changing_a_byte(name):
    """Tracer on: one encode.phase_a and one encode.pack (in that order, one
    image each) inside each strip's strip.encode, one strip.bytes inside
    strip.finish after strip.stitch, no device time on the CPU; the stream
    equals the tracer-off stream."""
    make, pieces = CASES[name]
    img = make()
    off = _strips(img, pieces)
    assert profiling.records() == []
    profiling.enable()
    assert _strips(img, pieces) == off
    rs = profiling.records()
    by_id = {r["id"]: r for r in rs}
    by = {}
    for r in rs:
        by.setdefault(r["name"], []).append(r)
    n = len(_strip_heights(pieces))
    assert {k: len(v) for k, v in by.items()} == {
        "strip.push": len(pieces), "strip.encode": n, "encode.phase_a": n, "encode.pack": n,
        "strip.finish": 1, "strip.stitch": 1, "strip.bytes": 1}
    encodes = [r["id"] for r in by["strip.encode"]]
    for k in ("encode.phase_a", "encode.pack"):
        assert [r["parent"] for r in by[k]] == encodes
        assert all(r["tiles"] == 1 for r in by[k])
    for a, p in zip(by["encode.phase_a"], by["encode.pack"]):
        assert a["t1_ns"] <= p["t0_ns"]
    (fin,), (stitch,), (nbytes,) = by["strip.finish"], by["strip.stitch"], by["strip.bytes"]
    assert nbytes["parent"] == stitch["parent"] == fin["id"]
    assert by_id[fin["id"]]["parent"] is None and nbytes["t0_ns"] >= stitch["t1_ns"]
    assert all(r["device_ms"] is None for r in rs)


def test_one_shot_encode_opens_phase_a_and_pack_once():
    """The one-shot encode of a u16 x 3 image takes the same route and
    opens the same two spans, once, with its stream unchanged."""
    img = photo16.image(256, 384, np.random.default_rng(64))
    off = qt.encode(img, device=CPU)
    assert off == qb3ref.encode(img, qb3ref.FTL)
    profiling.enable()
    assert qt.encode(img, device=CPU) == off
    names = [r["name"] for r in profiling.records()]
    assert names == ["encode.phase_a", "encode.pack"]


@pytest.mark.parametrize("totals", [
    [1_300_000_000],  # a photo's stream, one part
    [188_000_000] * 10 + [107_000_000],  # its 11 strips at ~16 bits a value, 1.987e9 bits
    [2**31 - 5, 2**31 + 7, 37, 0, 64],  # past 2^31 and 2^32
])
def test_stitch_offsets_stay_exact_past_2_to_the_31(totals):
    """The run table of K6's stitch entry at a scene's bit totals: each part's
    word base, end, words, shift and mask from its 64-bit bit offset, as
    Python integers compute them."""
    runs = stitch_runs(totals)
    assert runs.dtype == np.int64
    off, k = 0, 0
    for s, n in enumerate(totals):
        if n:
            assert list(runs[:, k]) == [s, off >> 5, (off + n + 31) >> 5, (n + 31) >> 5,
                                        off & 31, (1 << (n & 31)) - 1 if n & 31 else 2**32 - 1]
            k += 1
        off += n
    assert k == runs.shape[1]
