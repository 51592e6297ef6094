"""The best modes (CF, CF_H and their RLE forms) of qb3_tpu_torch against
qb3_tpu, on the CPU: phase A (encode_best_blocks) field by field, its pcf
scan and group GCD, the Encoder's streams with no sidecar, "ib" and "ic"
and their cut-offs, the "ic"-best decode (damaged streams too), the batch
encode and decode, the strips, the three best-mode web fixtures and the
best-mode sha256 pins of benchutil.  Inputs are made with numpy from a
seed; the tolerance is zero: bytes and arrays are equal.
"""

import base64
import hashlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qb3_tpu
import qb3_tpu_torch as qt
from qb3_tpu import errors as jerrors
from qb3_tpu.api import Encoder as JEncoder
from qb3_tpu.batch import decode_tiles as j_decode_tiles
from qb3_tpu.batch import encode_tiles as j_encode_tiles
from qb3_tpu.ops import encode_best as jbest
from qb3_tpu_torch import batch, container, framing
from qb3_tpu_torch.api import DT_FROM_NP, default_cband, to_carrier
from qb3_tpu_torch.benchutil import (BEST_HEADLINE_SHA256, LANDSAT_ENCODE_SHA256,
                                     LANDSAT_SAMPLE, headline_image)
from qb3_tpu_torch.constants import HILBERT, ZCURVE, Mode, is_best_mode
from qb3_tpu_torch.errors import QB3DataError, QB3ShapeError
from qb3_tpu_torch.ops import encode_best as tbest

from . import corpus
from .best_edges import kinds_scene

CPU = "cpu"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_j_blocks = jax.jit(jbest.encode_best_blocks, static_argnames=("order", "cband"))


def _j_outputs(img, order, cband):
    nb = img.shape[2]
    zero = jnp.zeros(nb, img.dtype)
    return [np.asarray(o) for o in _j_blocks(jnp.asarray(img), zero, jnp.zeros(nb, jnp.int32),
                                              zero, order=order, cband=cband)]


def _t_outputs(img, order, cband):
    nb = img.shape[2]
    zero = torch.zeros(nb, dtype=torch.int64)
    return tbest.encode_best_blocks(to_carrier(img, CPU), zero, zero, zero, order, cband,
                                    8 * img.itemsize)


# name -> raster: every type at 1, 3 and 8 bands, aligned and not
BLOCK_CASES = {
    "u8-16x20x3-kinds": lambda: kinds_scene(16, 20, 3, np.uint8, 1),
    "u8-5x7x1": lambda: corpus.natural8(5, 7, 1, seed=2) // 3 * 3,
    "u8-12x8x8-kinds": lambda: kinds_scene(12, 8, 8, np.uint8, 3),
    "u16-16x16x1-kinds": lambda: kinds_scene(16, 16, 1, np.uint16, 4),
    "u16-7x10x3": lambda: corpus.to_type(corpus.natural8(7, 10, 3, seed=5), np.uint16, 5),
    "u32-8x12x8-kinds": lambda: kinds_scene(8, 12, 8, np.uint32, 6),
    "u32-9x6x1": lambda: corpus.to_type(corpus.natural8(9, 6, 1, seed=7), np.uint32, 65537 * 3),
    "u64-16x12x1-kinds": lambda: kinds_scene(16, 12, 1, np.uint64, 8),
    "u64-12x8x3-kinds": lambda: kinds_scene(12, 8, 3, np.uint64, 9),
    "u64-5x9x1": lambda: corpus.random_noise(5, 9, 1, np.uint64, seed=10) >> np.uint64(30),
}


@pytest.mark.parametrize("name", list(BLOCK_CASES))
def test_encode_best_blocks_fields(name):
    """All nine outputs of phase A equal qb3_tpu's (codes and lengths,
    the exit band state, meta16, cfv, post-runbits and pcf_in); the
    "kinds" rasters reach every group kind."""
    img = BLOCK_CASES[name]()
    cband = tuple(default_cband(img.shape[2]))
    want = _j_outputs(img, HILBERT, cband)
    got = _t_outputs(img, HILBERT, cband)
    assert len(got) == len(want) == 9
    for i, (g, w) in enumerate(zip(got, want)):
        g = g.numpy()
        assert g.shape == w.shape, (i, g.shape, w.shape)
        np.testing.assert_array_equal(g.view(np.uint64) if g.dtype == np.int64
                                      else g.astype(np.uint64), w.astype(np.uint64),
                                      err_msg=f"output {i}")
    kinds = np.bincount(got[5].numpy() & 7, minlength=6)
    if "kinds" in name:
        assert (kinds[:6] > 0).all(), kinds


def test_pcf_scan_random():
    rng = np.random.default_rng(11)
    for nblocks, nb in ((1, 1), (7, 3), (64, 5)):
        is_set = rng.random((nblocks, nb)) < 0.3
        vals = rng.integers(0, 1 << 62, (nblocks, nb), dtype=np.int64)
        entry = rng.integers(0, 1 << 16, nb, dtype=np.int64)
        got = tbest.pcf_scan(torch.from_numpy(is_set), torch.from_numpy(vals),
                             torch.from_numpy(entry))
        want = jax.jit(jbest.pcf_scan)(jnp.asarray(is_set), jnp.asarray(vals.astype(np.uint64)),
                                       jnp.asarray(entry.astype(np.uint64)))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy().view(np.uint64), np.asarray(w))


@pytest.mark.parametrize("tbits", [8, 64])
def test_group_gcd_edges(tbits):
    """group_gcd against qb3_tpu's binary GCD, on random groups, zeros, ones
    and, at 64 bits, the magnitude 2^63 beside every kind of other value."""
    rng = np.random.default_rng(tbits)
    top = (1 << tbits) - 1
    m = rng.integers(0, 1 << min(tbits, 62), (64, 16), dtype=np.int64).astype(np.uint64)
    m[:8] &= np.uint64(~7 & top)  # common factors of 8
    m[8:16] = 0
    m[16:24, ::2] = 0
    m[24:32] = np.uint64(top)
    m[32:40, :4] = np.uint64(top)  # 2^(tbits - 1) beside other values
    m[40:48] = np.where(rng.integers(0, 2, (8, 16)) == 1, np.uint64(top), np.uint64(2 << 10))
    m[48:56, 1:] = 0
    m[48:56, 0] = np.uint64(top)
    m = m.astype(np.uint8) if tbits == 8 else m
    work = jnp.uint32 if tbits == 8 else jnp.uint64  # qb3_tpu's _work_dtype
    want = np.asarray(jax.jit(jbest.group_gcd, static_argnums=1)(jnp.asarray(m), work))
    got = tbest.group_gcd(torch.from_numpy(m.astype(np.uint64).view(np.int64)), tbits)
    np.testing.assert_array_equal(got.numpy().view(np.uint64), want.astype(np.uint64))
    if tbits == 64:
        assert (want[24:32] == np.uint64(1 << 63)).all()


def scan_order(mode) -> int:
    return ZCURVE if mode in (Mode.CF, Mode.CF_RLE) else HILBERT


# name -> raster for the Encoder's streams, made for a mode's scan order
STREAM_CASES = {
    "u8-rgb-kinds": lambda order: kinds_scene(16, 24, 3, np.uint8, 12, order),
    "u16-unaligned": lambda order: corpus.to_type(corpus.natural8(13, 18, 2, seed=13),
                                                  np.uint16, 7),
}


@pytest.mark.parametrize("index", [False, True, "ic"])
@pytest.mark.parametrize("mode", [Mode.CF, Mode.CF_H, Mode.CF_RLE, Mode.CF_RLE_H])
@pytest.mark.parametrize("name", list(STREAM_CASES))
def test_encoder_streams(name, mode, index):
    """Encoder bytes equal qb3_tpu.encode's in every best mode with no
    sidecar, "ib" and "ic"; the port decodes them to the raster."""
    img = STREAM_CASES[name](scan_order(mode))
    stream = qt.encode(img, mode=mode, index=index, device=CPU)
    assert stream == qb3_tpu.encode(img, mode=mode, index=index)
    assert is_best_mode(container.parse_headers(stream).mode)
    dec = qt.Decoder(stream, device=CPU)
    np.testing.assert_array_equal(dec.read_data(), img)
    want = {False: "native-walk", True: "ib", "ic": "ic-best"}[index]
    assert dec.decode_path in (want, "python-walk" if index is False else want)


def test_band_state_carries_across_images():
    """The previous CF, value and rung carry from one image to the next as
    in qb3_tpu's Encoder, and the "ic" sidecar's entry state with them."""
    imgs = [corpus.natural8(16, 20, 2, seed=s) // 5 * 5 for s in (14, 15)]
    jenc, enc = JEncoder(20, 16, 2, 0), qt.Encoder(20, 16, 2, 0, device=CPU)
    for e in (jenc, enc):
        e.set_mode(Mode.CF_H)
        e.with_index = "ic"
    for img in imgs:
        assert enc.encode(img) == jenc.encode(img)
        for attr in ("band_prev", "band_runbits", "band_cf"):
            np.testing.assert_array_equal(getattr(enc, attr), getattr(jenc, attr))
    assert enc.band_cf.any()


def test_sidecar_cutoffs():
    """The three cut-offs: a CF past 16 bits writes no "ib" sidecar (and
    "ic" falls back to "ib", then to none); an entry pcf past 16 bits makes
    chunk_spans_best give None; 2^31 bits of spans make the "ic" sidecar
    None, and framing.sidecar writes "ib" in their place.  Each as qb3_tpu
    decides it."""
    img = corpus.to_type(corpus.natural8(12, 16, 1, seed=16), np.uint32, 65537 * 3)
    for index in (True, "ic"):
        stream = qt.encode(img, mode=Mode.CF_H, index=index, device=CPU)
        assert stream == qb3_tpu.encode(img, mode=Mode.CF_H, index=index)
        info = container.parse_headers(stream)
        assert info.index_best is None and info.index_chunked is None
    # the encoder state of the "ic" sidecar, faked: 40000 one-band blocks
    n = 40000
    rng = np.random.default_rng(17)
    rungs = rng.integers(0, 8, (n, 1)).astype(np.int32)
    pcf = rng.integers(0, 1 << 16, (n, 1)).astype(np.int64)
    meta16, cfv = np.zeros(n, np.int32), np.zeros(n, np.int64)  # no CF group: "ib" fits
    for glen, big_pcf in ((60000, False), (100, True), (100, False)):
        glens = np.full(n, glen, np.int64)
        p = pcf.copy()
        if big_pcf:
            p[8 * 7] = 1 << 20  # the entry state of chunk 7
        jenc = JEncoder(400, 1600, 1, 0)
        jenc._last_glens, jenc._last_rungs, jenc._last_pcf = glens.astype(np.uint16), rungs, p
        entry = np.zeros(1, np.int32), np.zeros(1, np.uint64)
        got, sig = framing.sidecar("ic", glens.astype(np.uint16), rungs, entry[0], meta16=meta16,
                                   cfv=cfv, pcf_in=p, entry_cf=entry[1])
        want = jenc._chunked_sidecar_best(*entry)
        assert (sig == b"ic") == (want is not None)
        assert got == (want if sig == b"ic" else framing.best_sidecar(glens, meta16, cfv))
        assert (want is None) == (glen == 60000 or big_pcf)


def _ic_best_stream(name):
    img = STREAM_CASES[name](HILBERT)
    return qb3_tpu.encode(img, mode=Mode.CF_H, index="ic"), img


@pytest.mark.parametrize("name", list(STREAM_CASES))
def test_ic_best_decode_equal(name):
    stream, img = _ic_best_stream(name)
    assert container.parse_headers(stream).index_chunked is not None
    dec = qt.Decoder(stream, device=CPU)
    out = dec.read_data()
    assert dec.decode_path == "ic-best"
    np.testing.assert_array_equal(out, qb3_tpu.decode(stream)[0])
    np.testing.assert_array_equal(out, img)


@pytest.mark.parametrize("dtype", [np.uint32, np.uint64])
def test_ic_best_decode_wide(dtype):
    """u32 and u64 "ic"-best streams (every kind, with factors of 16 bits at
    most; u64 with the magnitude 2^63 and rung 63's 65-bit codes) decode to
    the raster, as their "ib" and walk decodes do (qb3_tpu's u64 chunk walk
    takes ~25 s to compile on the CPU: its arrays are held equal at u8 and
    u16)."""
    img = kinds_scene(12, 16, 1, dtype, 18, fbits=16)
    stream = qb3_tpu.encode(img, mode=Mode.CF_H, index="ic")
    assert stream == qt.encode(img, mode=Mode.CF_H, index="ic", device=CPU)
    dec = qt.Decoder(stream, device=CPU)
    np.testing.assert_array_equal(dec.read_data(), img)
    assert dec.decode_path == "ic-best"
    for index in (True, False):
        dec = qt.Decoder(qt.encode(img, mode=Mode.CF_H, index=index, device=CPU), device=CPU)
        np.testing.assert_array_equal(dec.read_data(), img)


@pytest.mark.parametrize("damage", ["extra-bytes", "truncated", "bit-flip"])
def test_damaged_ic_best_stream_decodes_like_qb3_tpu(damage):
    """The same array and the same error as qb3_tpu's "ic"-best decode."""
    stream, _ = _ic_best_stream("u8-rgb-kinds")
    if damage == "extra-bytes":
        stream += b"\x5a\xa5"
    elif damage == "truncated":
        stream = stream[:-40]
    else:
        stream = stream[:-200] + bytes([stream[-200] ^ 0x10]) + stream[-199:]
    outs = []
    for dec in (qt.Decoder(stream, device=CPU), qb3_tpu.Decoder(stream)):
        outs.append((dec.read_data(partial=True), dec.failed, dec.decode_path))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    assert outs[0][1:] == outs[1][1:] == (damage == "extra-bytes", "ic-best")
    for dec in (qt.Decoder(stream, device=CPU), qb3_tpu.Decoder(stream)):
        if damage == "extra-bytes":
            with pytest.raises((QB3DataError, jerrors.QB3DataError), match="leftover bits"):
                dec.read_data()
        else:
            dec.read_data()


@pytest.mark.parametrize("index", [False, True, "ic"])
@pytest.mark.parametrize("mode", [Mode.CF_H, Mode.CF])
def test_tiles_best(mode, index):
    """encode_tiles equals qb3_tpu's, "ib" sidecars written for index True
    and "ic"; decode_tiles of the "ib" streams equals qb3_tpu's."""
    tiles = np.stack([kinds_scene(16, 12, 3, np.uint8, s, scan_order(mode)) for s in (20, 21, 22)])
    streams = qt.encode_tiles(tiles, mode=mode, index=index, device=CPU)
    assert streams == j_encode_tiles(tiles, mode=mode, index=index)
    assert streams[1] == qt.encode(tiles[1], mode=mode, index=bool(index), device=CPU)
    if index:
        assert container.parse_headers(streams[0]).index_best is not None
        out = qt.decode_tiles(streams, device=CPU)
        np.testing.assert_array_equal(out, j_decode_tiles(streams))
        np.testing.assert_array_equal(out, tiles)


def test_tiles_best_grouping(monkeypatch):
    """A tile's bytes do not depend on how many tiles share a pass of the
    best modes' phase A."""
    tiles = np.stack([corpus.to_type(corpus.natural8(8, 8, 2, seed=s), np.uint16, 3)
                      for s in range(5)])
    whole = qt.encode_tiles(tiles, mode=Mode.CF_H, index=True, device=CPU)
    monkeypatch.setattr(batch, "BEST_GROUPS", 2 * 4 * 2)  # two tiles a pass
    assert qt.encode_tiles(tiles, mode=Mode.CF_H, index=True, device=CPU) == whole
    monkeypatch.setattr(batch, "BEST_GROUPS", 1)  # one tile a pass
    assert qt.encode_tiles(tiles, mode=Mode.CF_H, index=True, device=CPU) == whole


def test_tiles_best_ic_sidecars_raise():
    """Best streams that carry "ic" sidecars: qb3_tpu's decode_tiles raises
    "inconsistent ic sidecar" (parse_ic refuses the best anchors), and so
    does the port's."""
    tiles = [corpus.natural8(8, 12, 1, seed=s) // 3 * 3 for s in (23, 24)]
    streams = [qb3_tpu.encode(t, mode=Mode.CF_H, index="ic") for t in tiles]
    assert all(container.parse_headers(s).index_chunked is not None for s in streams)
    for fn in (lambda: qt.decode_tiles(streams, device=CPU), lambda: j_decode_tiles(streams)):
        with pytest.raises((QB3ShapeError, jerrors.QB3ShapeError),
                           match="inconsistent ic sidecar"):
            fn()


def _strips(cls, img, mode, index, pieces, strip_rows, **kw):
    h, w, c = img.shape
    se = cls(w, h, c, DT_FROM_NP[img.dtype], mode=mode, strip_rows=strip_rows,
             with_index=index, **kw)
    a = 0
    for n in pieces:
        se.push(img[a:a + n])
        a += n
    return se.finish()


# name -> (raster, mode, row pieces, strip rows)
STRIP_CASES = {
    "u8-cf-h": (lambda: corpus.natural8(40, 24, 3, seed=25) // 3 * 3, Mode.CF_H, [7, 13, 20], 8),
    "u8-cf-rle-h-unaligned": (lambda: corpus.natural8(38, 20, 1, seed=26) // 5 * 5,
                              Mode.CF_RLE_H, [38], 16),
    "u16-cf-kinds": (lambda: kinds_scene(32, 16, 2, np.uint16, 27, ZCURVE), Mode.CF, [5, 27], 8),
}


@pytest.mark.parametrize("index", [False, True, "ic"])
@pytest.mark.parametrize("name", list(STRIP_CASES))
def test_best_strips(name, index):
    """StripEncoder bytes equal qb3_tpu's StripEncoder's and the
    whole-image encode; StripDecoder reads equal qb3_tpu's StripDecoder's
    and the raster."""
    make, mode, pieces, rows = STRIP_CASES[name]
    img = make()
    stream = _strips(qt.StripEncoder, img, mode, index, pieces, rows, device=CPU)
    assert stream == _strips(qb3_tpu.StripEncoder, img, mode, index, pieces, rows)
    assert stream == qt.encode(img, mode=mode, index=bool(index), device=CPU)
    reads = []
    for sd in (qt.StripDecoder(stream, strip_rows=rows, device=CPU),
               qb3_tpu.StripDecoder(stream, strip_rows=rows)):
        out = []
        while (r := sd.read(rows // 2 + 4)) is not None:
            out.append(r)
        reads.append(np.concatenate(out))
    np.testing.assert_array_equal(reads[0], reads[1])
    np.testing.assert_array_equal(reads[0], img)


def _fixtures():
    with open(os.path.join(ROOT, "web", "test", "fixtures.js")) as f:
        text = f.read()
    cases = json.loads(text[text.index("["): text.rindex("]") + 1])
    return {c["name"]: c for c in cases
            if is_best_mode(container.parse_headers(base64.b64decode(c["stream"])).mode)}


BEST_FIXTURES = _fixtures()


@pytest.mark.parametrize("name", list(BEST_FIXTURES))
def test_best_web_fixture_reencodes(name):
    """The three best-mode web fixtures (streams pinned to the C reference)
    re-encode to their bytes."""
    c = BEST_FIXTURES[name]
    stream = base64.b64decode(c["stream"])
    info = container.parse_headers(stream)
    raw = np.frombuffer(base64.b64decode(c["raw"]), np.dtype(c["dtype"])).reshape(c["shape"])
    assert qt.encode(raw, mode=info.mode, quanta=info.quanta, coreband=info.cband,
                     device=CPU) == stream


def test_best_fixture_count():
    assert len(BEST_FIXTURES) == 3


def test_best_sha256_pins():
    """The constants chip_smoke.py checks on the card, re-derived from both
    packages: the u8 512x512x3 CF_H headline with "ib" and with "ic", and
    the Landsat sample decoded and re-encoded (CF_H, its core bands)."""
    img = headline_image()
    for index, sig in ((True, "ib"), ("ic", "ic")):
        stream = qb3_tpu.encode(img, mode=Mode.CF_H, index=index)
        assert hashlib.sha256(stream).hexdigest() == BEST_HEADLINE_SHA256[sig]
        assert qt.encode(img, mode=Mode.CF_H, index=index, device=CPU) == stream
    with open(os.path.join(ROOT, LANDSAT_SAMPLE), "rb") as f:
        sample = f.read()
    info = container.parse_headers(sample)
    raster = qb3_tpu.decode(sample)[0]
    stream = qb3_tpu.encode(raster, mode=info.mode, coreband=info.cband)
    assert hashlib.sha256(stream).hexdigest() == LANDSAT_ENCODE_SHA256
    assert qt.encode(raster, mode=info.mode, coreband=info.cband, device=CPU) == stream
