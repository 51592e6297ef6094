"""The sharded decode of qb3_tpu_torch (parallel/sharded.decode_fast_sharded)
against qb3_tpu's, on the CPU: each case of tests/test_sharded_decode.py
with the shards on ["cpu"] * n ("ix", "ib" and "ic" sidecars, u8 to u64,
chunk anchors that do not align with the strips, k = 8 and k = 3), the
streams of the port's sharded encode, the shard windows, the "ix" window
span, and the errors.  qb3_tpu's decode_fast_sharded runs once a sidecar on
the 8 virtual CPU devices of tests/conftest.py; elsewhere the port is held
to the raster.  The tolerance is zero.
"""

import numpy as np
import pytest

import qb3_tpu
from qb3_tpu.api import DT_FROM_NP as J_DT_FROM_NP
from qb3_tpu.api import Encoder as JEncoder
from qb3_tpu.parallel import sharded as jsh
from qb3_tpu_torch import container
from qb3_tpu_torch.constants import Mode
from qb3_tpu_torch.errors import QB3ShapeError
from qb3_tpu_torch.parallel import sharded as tsh

from . import corpus
from .best_edges import kinds_scene


def cpu(n):
    return ["cpu"] * n


def decode(stream, n_dev):
    return tsh.decode_fast_sharded(stream, n_dev, devices=cpu(n_dev))


@pytest.mark.parametrize("n_dev", [2, 8])
def test_sharded_decode_u8(n_dev):
    img = corpus.natural8(32 * n_dev, 64, 3, seed=300 + n_dev)
    s = qb3_tpu.encode(img, mode=Mode.FTL, index=True)
    out = decode(s, n_dev)
    np.testing.assert_array_equal(out, img)
    assert out.dtype == img.dtype
    if n_dev == 2:  # qb3_tpu's own sharded decode, once a sidecar
        np.testing.assert_array_equal(out, jsh.decode_fast_sharded(s, n_dev))


def test_sharded_decode_u16_base():
    img = corpus.to_type(corpus.natural8(64, 48, 2, seed=310), np.uint16, 257)
    s = qb3_tpu.encode(img, mode=Mode.BASE_H, index=True)
    np.testing.assert_array_equal(decode(s, 4), img)


def test_sharded_decode_u64():
    img = corpus.to_type(corpus.natural8(64, 32, 1, seed=311), np.uint64, 1 << 40)
    s = qb3_tpu.encode(img, mode=Mode.FTL, index=True)
    np.testing.assert_array_equal(decode(s, 8), img)


@pytest.mark.parametrize("dtype", [np.int16, np.int32])
def test_sharded_decode_signed(dtype):
    img = (corpus.natural8(32, 32, 2, seed=312).astype(np.int64) - 128).astype(dtype)
    s = qb3_tpu.encode(img, mode=Mode.BASE_Z, index=True)
    out = decode(s, 4)
    assert out.dtype == img.dtype
    np.testing.assert_array_equal(out, img)


@pytest.mark.parametrize("n_dev", [2, 8])
def test_sharded_decode_ib_best(n_dev):
    img = corpus.natural8(32 * n_dev, 32, 3, seed=320 + n_dev)
    s = qb3_tpu.encode(img, mode=Mode.CF_H, index=True)
    out = decode(s, n_dev)
    np.testing.assert_array_equal(out, img)
    if n_dev == 2:
        np.testing.assert_array_equal(out, jsh.decode_fast_sharded(s, n_dev))


def test_sharded_decode_ib_u64():
    img = corpus.to_type(corpus.natural8(64, 32, 1, seed=321), np.uint64, 5)
    s = qb3_tpu.encode(img, mode=Mode.CF_H, index=True)
    np.testing.assert_array_equal(decode(s, 4), img)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.uint64])
def test_sharded_decode_ib_every_kind(dtype):
    """"ib" strips whose groups reach every kind (CF, CF0, IDX among them);
    the common factors stay below 2^16, so the stream keeps its sidecar."""
    img = kinds_scene(32, 24, 3 if dtype == np.uint8 else 1, dtype, 322, fbits=16)
    s = qb3_tpu.encode(img, mode=Mode.CF_H, index=True)
    assert container.parse_headers(s).index_best is not None
    np.testing.assert_array_equal(decode(s, 4), img)


@pytest.mark.parametrize("n_dev", [2, 8])
def test_sharded_decode_ic(n_dev):
    # ic chunks (K = 8 blocks) split evenly: H/4/n_dev rows of W/4 blocks
    img = corpus.natural8(16 * n_dev, 128, 3, seed=330 + n_dev)
    s = qb3_tpu.encode(img, mode=Mode.FTL, index="ic")
    out = decode(s, n_dev)
    np.testing.assert_array_equal(out, img)
    if n_dev == 2:
        np.testing.assert_array_equal(out, jsh.decode_fast_sharded(s, n_dev))


def test_sharded_decode_ic_u16_base():
    img = corpus.to_type(corpus.natural8(32, 128, 2, seed=331), np.uint16, 257)
    s = qb3_tpu.encode(img, mode=Mode.BASE_H, index="ic")
    np.testing.assert_array_equal(decode(s, 2), img)


def test_sharded_decode_ic_u32():
    """u32 / u64 "ic" shards take the plain chunk walk, as in qb3_tpu."""
    img = corpus.to_type(corpus.natural8(32, 64, 1, seed=332), np.uint32, 65537)
    s = qb3_tpu.encode(img, mode=Mode.FTL, index="ic")
    np.testing.assert_array_equal(decode(s, 4), img)


def test_sharded_decode_ic_unaligned_chunks():
    """Chunk anchors (K = 8 blocks) need not align with shard boundaries:
    a 32x80x1 image over 8 shards puts 20 blocks (2.5 chunks) in a shard,
    so every strip but the first starts mid-chunk."""
    img = corpus.natural8(32, 80, 1, seed=350)
    s = qb3_tpu.encode(img, mode=Mode.FTL, index="ic")
    np.testing.assert_array_equal(decode(s, 8), img)


def test_sharded_decode_ic_unaligned_chunks_k3():
    img = corpus.natural8(48, 52, 3, seed=351)
    e = JEncoder(52, 48, 3, J_DT_FROM_NP[img.dtype])
    e.set_mode(Mode.FTL)
    e.with_index = "ic"
    e.index_chunk_blocks = 3
    s = e.encode(img)
    np.testing.assert_array_equal(decode(s, 4), img)


@pytest.mark.parametrize("mode,index", [(Mode.FTL, True), (Mode.BASE_H, "ic"),
                                        (Mode.CF_H, True)], ids=["ix", "ic", "ib"])
def test_port_sharded_round_trip(mode, index):
    """The port's sharded encode, then its sharded decode, on other shard
    counts."""
    img = corpus.natural8(64, 64, 3, seed=360)
    s = tsh.encode_sharded(img, 4, mode=mode, index=index, devices=cpu(4))
    np.testing.assert_array_equal(decode(s, 8), img)
    np.testing.assert_array_equal(decode(s, 2), img)


def test_shard_windows_match_qb3_tpu():
    rng = np.random.default_rng(3)
    words = rng.integers(0, 1 << 63, 40, dtype=np.uint64)
    start = np.array([0, 300, 900, 2400], np.int64)
    end = np.array([300, 900, 2400, 2500], np.int64)
    got = tsh._shard_windows(words, start, end, 5)
    want = jsh._shard_windows(words, start, end, 5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_ix_span_covers_the_groups():
    """K7's span for an "ix" shard, sized on the host from the groups'
    start bits, covers each group's window word wherever its first value
    bit lies (at most ubits + 3 bits past its start)."""
    from qb3_tpu_torch.ops.decode import _NREG_IX
    from qb3_tpu_torch.ops.gather_cuda import gather_span

    rng = np.random.default_rng(4)
    for tbits in (8, 16, 32, 64):
        goff = np.cumsum(rng.integers(1, 300, 5000))
        R = tsh._ix_span(goff, tbits, 1 << 20)
        ubits = {8: 3, 16: 4, 32: 5, 64: 6}[tbits]
        for shift in range(ubits + 4):
            assert gather_span((goff + shift) >> 5, _NREG_IX[tbits]) <= R


def test_sharded_decode_errors():
    img = corpus.natural8(32, 32, 1, seed=370)
    with pytest.raises(QB3ShapeError, match="whole block rows"):
        decode(qb3_tpu.encode(img, index=True), 3)
    with pytest.raises(QB3ShapeError, match="needs an ix/ib/ic"):
        decode(qb3_tpu.encode(img), 4)
