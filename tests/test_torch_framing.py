"""qb3_tpu_torch/framing.py, the framing every encode entry shares, on the
CPU: the sidecar rule per kind and mode family against the sidecar chunk of
qb3_tpu's matching entry (the one-shot encode and the tile batch), each
cut-off on made-up pieces, the RLE0 post-pass's two size tests and the mode
its header names, and the stored fallback: the one-shot encode's, none in
StripEncoder.  Rasters are at most 32x32x3."""

import numpy as np
import pytest

import qb3_tpu
import qb3_tpu_torch as qt
from qb3_tpu.batch import encode_tiles as j_encode_tiles
from qb3_tpu_torch import batch, container, framing, rle
from qb3_tpu_torch.api import put_on
from qb3_tpu_torch.constants import DType, Mode
from qb3_tpu_torch.offsets import KIND_CF

from . import corpus

CPU = "cpu"
FAMILIES = {"fast": Mode.FTL, "best": Mode.CF_H}
INDEXES = {"none": False, "ix": True, "ic": "ic"}


def _chunk(stream: bytes, sig: bytes):
    """The sidecar chunk of sig in a stream's header (None if absent)."""
    info = container.parse_headers(stream)
    return {b"ix": info.index, b"ic": info.index_chunked, b"ib": info.index_best}[sig]


def _sidecars(stream: bytes) -> list:
    info = container.parse_headers(stream)
    return [x for x in (info.index, info.index_chunked, info.index_best) if x is not None]


@pytest.mark.parametrize("index", list(INDEXES))
@pytest.mark.parametrize("family", list(FAMILIES))
def test_encoder_sidecar_matches_qb3_tpu(family, index):
    """The one-shot encode's pieces through framing.sidecar give the chunk
    of qb3_tpu.encode's stream; a best mode's "ic" is the best "ic"."""
    mode, index = FAMILIES[family], INDEXES[index]
    img = corpus.natural8(32, 32, 3, seed=270)
    enc = qt.Encoder(32, 32, 3, DType.U8, device=CPU)
    enc.set_mode(mode)
    enc.with_index = index
    _, _, pieces = enc._encode_payload(img, mode)
    got, sig = framing.sidecar(index, **pieces, entry_runbits=enc.band_runbits,
                               entry_cf=enc.band_cf)
    want = qb3_tpu.encode(img, mode=mode, index=index)
    if not index:
        assert got is None and _sidecars(want) == []
        return
    assert sig == {(True, "fast"): b"ix", (True, "best"): b"ib"}.get((index, family), b"ic")
    assert got == _chunk(want, sig) and got is not None


@pytest.mark.parametrize("index", list(INDEXES))
@pytest.mark.parametrize("family", list(FAMILIES))
def test_batch_sidecar_matches_qb3_tpu(family, index):
    """encode_dispatch's pieces of each tile through framing.sidecar give
    the chunk of qb3_tpu's encode_tiles stream; a best batch writes "ib"
    for "ic" too."""
    mode, index = FAMILIES[family], INDEXES[index]
    tiles = np.stack([corpus.natural8(16, 32, 3, seed=271 + i) for i in range(2)])
    plan = batch.plan_encode(tiles, mode, index=index)
    out = batch.encode_dispatch(plan, batch.upload_tiles(plan, put_on(CPU)), CPU)
    host = {k: v.numpy() for k, v in out.items() if k not in ("words", "totals")}
    for i, want in enumerate(j_encode_tiles(tiles, mode=mode, index=index)):
        got, sig = framing.sidecar(index, **{k: v[i] for k, v in host.items()})
        if not index:
            assert got is None and _sidecars(want) == []
            continue
        assert sig == (b"ib" if family == "best" else b"ic" if index == "ic" else b"ix")
        assert got == _chunk(want, sig) and got is not None


def _best_pieces(n=64, cf=2, pcf=0, glen=100):
    """Made-up best-mode pieces of n one-band blocks: every group a CF group
    with factor cf, pcf the biased CF before each block."""
    return dict(glen=np.full(n, glen, np.int64), rung=np.zeros((n, 1), np.int32),
                meta16=np.full(n, KIND_CF, np.int32), cfv=np.full(n, cf, np.int64),
                pcf_in=np.full((n, 1), pcf, np.int64))


# name -> (index, sidecar's arguments, the signature written, None or bytes)
CUTOFF_CASES = {
    "ic-spans-below-2^31": ("ic", dict(spans=np.array([(1 << 31) - 1], np.uint32),
                                       entry=np.zeros((1, 1), np.uint8)), b"ic", True),
    "ic-spans-at-2^31": ("ic", dict(spans=np.array([1 << 30, 1 << 30], np.uint32),
                                    entry=np.zeros((2, 1), np.uint8)), b"ix", False),
    "ic-glens-at-2^31": ("ic", dict(glen=np.full(1 << 16, 1 << 15, np.int64),
                                    rung=np.zeros((1 << 16, 1), np.int32)), b"ix", False),
    "ib-cf-16-bits": (True, _best_pieces(cf=0xFFFF), b"ib", True),
    "ib-cf-past-16-bits": (True, _best_pieces(cf=0x10000), b"ib", False),
    "ib-for-ic-without-entry-cf": ("ic", _best_pieces(), b"ib", True),
    "best-ic": ("ic", dict(_best_pieces(pcf=0xFFFF), entry_cf=np.zeros(1, np.uint64)),
                b"ic", True),
    "best-ic-pcf-past-16-bits": ("ic", dict(_best_pieces(pcf=0x10000),
                                            entry_cf=np.zeros(1, np.uint64)), b"ib", True),
    "best-ic-spans-at-2^31": ("ic", dict(_best_pieces(n=1 << 16, glen=1 << 15),
                                         entry_cf=np.zeros(1, np.uint64)), b"ib", True),
    "best-ic-then-ib-past-16-bits": ("ic", dict(_best_pieces(cf=0x10000, pcf=0x10000),
                                                entry_cf=np.zeros(1, np.uint64)), b"ib", False),
}


@pytest.mark.parametrize("name", list(CUTOFF_CASES))
def test_sidecar_cutoffs(name):
    """Each cut-off on made-up pieces: no "ic" past 2^31 bits of spans (the
    device walk's int32 cursors), no best "ic" past a 16-bit pcf or 2^31
    bits (then "ib"), no "ib" past a 16-bit CF; a best "ic" needs entry_cf
    (the one-shot encode's)."""
    index, kw, want_sig, written = CUTOFF_CASES[name]
    got, sig = framing.sidecar(index, **kw)
    assert sig == want_sig and (got is not None) == written
    if name == "ib-for-ic-without-entry-cf":
        assert got == framing.best_sidecar(kw["glen"], kw["meta16"], kw["cfv"])


FRAME = framing.Frame(32, 32, 1, DType.U8, [0], 1, 0)
ZEROS = bytes(400) + b"\x01\x02\x03"  # RLE0 shrinks it to a few bytes


def _result_len(payload: bytes) -> int:
    return len(FRAME.header(Mode.BASE_H)) + len(payload)


# name -> (payload, max_size from the coded stream's length, post-pass taken)
RLE_CASES = {
    "taken": (ZEROS, lambda n: 4 * n, True),
    "half-size-at-limit": (ZEROS, lambda n: 2 * n + 1, True),
    "half-size-over-limit": (ZEROS, lambda n: 2 * n - 1, False),
    "no-shrink": (bytes(np.random.default_rng(272).integers(1, 255, 400, np.uint8)),
                  lambda n: 4 * n, False),
}


@pytest.mark.parametrize("name", list(RLE_CASES))
def test_rle_post_pass_size_tests(name):
    """The post-pass runs only where the coded stream is at most half of
    max_size and it shrinks the payload (QB3encode.cpp:536-566); its header
    then names the user's mode, else the coding mode."""
    payload, max_size, taken = RLE_CASES[name]
    stream = FRAME.finish(Mode.RLE_H, payload, (None, b"ix"), max_size(_result_len(payload)))
    info = container.parse_headers(stream)
    if taken:
        assert info.mode == Mode.RLE_H and stream[info.data_offset:] == rle.rle0_encode(payload)
    else:
        assert info.mode == Mode.BASE_H and stream[info.data_offset:] == payload


@pytest.mark.parametrize("mode", [Mode.RLE_H, Mode.CF_RLE_H], ids=["rle-h", "cf-rle-h"])
def test_rle_header_names_user_mode(mode):
    """A compressible raster's RLE stream names the user's mode and keeps
    the coding mode's sidecar, as qb3_tpu's does."""
    img = np.zeros((32, 32, 1), np.uint8)
    img[8:20, 8:20] = 77
    stream = qt.encode(img, mode=mode, index=True, device=CPU)
    assert stream == qb3_tpu.encode(img, mode=mode, index=True)
    info = container.parse_headers(stream)
    assert info.mode == mode and _sidecars(stream)


# name -> (mode, store_rle, raw bytes beside the coded stream's length, stored)
STORED_CASES = {"coded-smaller": (Mode.BASE_H, False, 1, False),
                "coded-equal": (Mode.BASE_H, False, 0, True),
                "coded-larger": (Mode.BASE_H, False, -1, True),
                "rle-keeps-coded": (Mode.RLE_H, False, -1, False),
                "rle-store-rle": (Mode.RLE_H, True, -1, True),
                "rle-store-rle-coded-smaller": (Mode.RLE_H, True, 1, False)}


@pytest.mark.parametrize("name", list(STORED_CASES))
def test_stored_fallback_rule(name):
    """Frame.finish stores the raw raster unless the coded stream is smaller;
    an RLE mode whose post-pass is not taken only with store_rle (the
    shards'); without raw (StripEncoder) it never stores."""
    mode, store_rle, extra, stored = STORED_CASES[name]
    payload = bytes(range(1, 201))  # RLE0 does not shrink it
    raw = np.zeros(_result_len(payload) + extra, np.uint8)
    frame = FRAME._replace(xsize=raw.size, ysize=1)
    stream = frame.finish(mode, payload, (None, b"ix"), 1 << 20, raw=raw, store_rle=store_rle)
    assert framing.is_stored(stream) == stored
    assert stream == (frame.stored(raw) if stored else frame.header(Mode.BASE_H) + payload)
    assert not framing.is_stored(frame.finish(mode, payload, (None, b"ix"), 1 << 20,
                                              store_rle=store_rle))


def test_encoder_stores_strip_encoder_does_not():
    """Noise: the one-shot encode stores it, as qb3_tpu's does; StripEncoder
    keeps the coded stream, as qb3_tpu's StripEncoder does."""
    img = corpus.random_noise(16, 16, 1, np.uint8, seed=135)
    one = qt.encode(img, mode=Mode.FTL, device=CPU)
    assert framing.is_stored(one) and one == qb3_tpu.encode(img, mode=Mode.FTL)
    se = qt.StripEncoder(16, 16, 1, DType.U8, strip_rows=8, device=CPU)
    se.push(img)
    strip = se.finish()
    jse = qb3_tpu.StripEncoder(16, 16, 1, DType.U8, strip_rows=8)
    jse.push(img)
    assert strip == jse.finish() and not framing.is_stored(strip)
    assert len(strip) >= img.nbytes and qt.decode(strip, device=CPU)[0].tobytes() == img.tobytes()
