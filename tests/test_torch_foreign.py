"""qb3_tpu_torch.foreign on the CPU: bulk decode of streams without a
sidecar (written by qb3_tpu's default encode, whose bytes are the C
reference's) in FTL, BASE_H, RLE_H and CF_H, u8 and u16, against the
inputs and qb3_tpu.decode of each stream; the pipelined form over three
batches; one walker thread against a pool; and the raises (mixed shapes,
quanta 2, STORED, unaligned tiles, a damaged stream).  qb3_tpu.foreign is
not called: it reads qb3_tpu.native, which is None whenever qb3_tpu's
in-place native build races.  The tolerance is zero."""

import numpy as np
import pytest

import qb3_tpu
import qb3_tpu_torch as qt
from qb3_tpu_torch import container, foreign
from qb3_tpu_torch.api import walk_offsets
from qb3_tpu_torch.constants import Mode
from qb3_tpu_torch.errors import QB3ShapeError

from . import corpus

CPU = "cpu"


def _tiles(n, seed, h=64, w=64, c=3, dtype=np.uint8, mult=1):
    return [corpus.to_type(corpus.natural8(h, w, c, seed=seed + i), dtype, mult)
            for i in range(n)]


def _arrays(out):
    t, np_dt = out
    return t.numpy().view(np_dt)


@pytest.mark.parametrize("dtype,mult", [(np.uint8, 1), (np.uint16, 181)], ids=["u8", "u16"])
@pytest.mark.parametrize("mode", [Mode.FTL, Mode.BASE_H, Mode.RLE_H, Mode.CF_H],
                         ids=lambda m: m.name)
def test_decode_streams_equals_inputs_and_qb3_tpu(mode, dtype, mult):
    tiles = _tiles(4, seed=int(mode) * 10, dtype=dtype, mult=mult)
    streams = [qb3_tpu.encode(t, mode=mode) for t in tiles]
    assert all(container.parse_headers(s).index is None for s in streams)
    out = _arrays(foreign.decode_streams(streams, device=CPU))
    assert out.dtype == dtype and out.shape == (4, 64, 64, 3)
    for o, t, s in zip(out, tiles, streams):
        np.testing.assert_array_equal(o, t)
        np.testing.assert_array_equal(o, qb3_tpu.decode(s)[0])


def test_decode_streams_pipelined_over_three_batches():
    batches = [_tiles(3, seed=100 + 10 * b) for b in range(3)]
    streams = [[qt.encode(t, device=CPU) for t in b] for b in batches]
    decs = list(foreign.decode_streams_pipelined(iter(streams), device=CPU))
    assert len(decs) == 3
    for d, b in zip(decs, batches):
        np.testing.assert_array_equal(d, np.stack(b))


@pytest.mark.parametrize("mode", [Mode.RLE_H, Mode.CF_H], ids=lambda m: m.name)
def test_one_walker_equals_a_pool(mode):
    """The walks share no state: one thread, four and more threads than
    the machine has cores give the same arrays."""
    streams = [qt.encode(t, mode=mode, device=CPU) for t in _tiles(6, seed=200)]
    one = _arrays(foreign.decode_streams(streams, workers=1, device=CPU))
    for workers in (4, 16):
        np.testing.assert_array_equal(
            _arrays(foreign.decode_streams(streams, workers=workers, device=CPU)), one)


def _damaged():
    """A CF_H stream whose payload is random bytes: its walk fails."""
    s = qt.encode(corpus.natural8(64, 64, 3, seed=300), mode=Mode.CF_H, device=CPU)
    info = container.parse_headers(s)
    junk = np.random.default_rng(1).integers(0, 256, len(s) - info.data_offset, np.uint8)
    bad = s[: info.data_offset] + junk.tobytes()
    meta, _ = walk_offsets(bad[info.data_offset:], 256, 3, 1, Mode.CF_H)
    assert meta["failed"]
    return [s, bad]


@pytest.mark.parametrize("case,match", [
    ("mixed", "same-shape"), ("quanta", "quantized"), ("stored", "stored"),
    ("unaligned", "4-aligned"), ("damaged", "corrupt stream")])
def test_decode_streams_raises(case, match):
    enc = lambda img, **kw: qt.encode(img, device=CPU, **kw)  # noqa: E731
    if case == "mixed":
        streams = [enc(corpus.natural8(64, 64, 3, seed=1)),
                   enc(corpus.natural8(32, 64, 3, seed=2))]
    elif case == "quanta":
        streams = [enc(corpus.natural8(64, 64, 3, seed=3), quanta=2)]
    elif case == "stored":
        streams = [enc(corpus.natural8(4, 4, 1, seed=4))]
        assert container.parse_headers(streams[0]).mode == Mode.STORED
    elif case == "unaligned":
        streams = [enc(corpus.natural8(30, 30, 3, seed=5))]
    else:
        streams = _damaged()
    with pytest.raises(QB3ShapeError, match=match):
        foreign.decode_streams(streams, device=CPU)
