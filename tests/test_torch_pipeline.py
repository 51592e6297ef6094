"""qb3_tpu_torch.pipeline against qb3_tpu.pipeline, on the CPU: the
pipelined encode's streams byte for byte (FTL, BASE_H and BASE_Z, each
with no sidecar, "ix" and "ic"; a u16 batch; qb3_tpu's Hilbert-order
BASE_Z bytes and its CF_H bytes), the adaptive fetch cap and its fallback,
the pipelined decode's arrays ("ic", "ix", "ib") and its raises.  The
tolerance is zero: bytes and arrays are equal."""

import numpy as np
import pytest

import qb3_tpu
import qb3_tpu_torch as qt
from qb3_tpu import pipeline as jpipeline
from qb3_tpu.batch import encode_tiles as j_encode_tiles
from qb3_tpu_torch import container, pipeline
from qb3_tpu_torch.constants import HILBERT, ZCURVE, Mode
from qb3_tpu_torch.errors import QB3ShapeError

from . import corpus

CPU = "cpu"


def _batches(nbatches, n, seed, c=3, dtype=np.uint8, mult=1):
    return [np.stack([corpus.to_type(corpus.natural8(64, 64, c, seed=seed + 10 * b + i),
                                     dtype, mult) for i in range(n)])
            for b in range(nbatches)]


def _round_trips(outs, batches):
    for streams, tiles in zip(outs, batches):
        assert len(streams) == len(tiles)
        for s, t in zip(streams, tiles):
            np.testing.assert_array_equal(qt.decode(s, device=CPU)[0], t)


@pytest.mark.parametrize("index", [False, True, "ic"], ids=["none", "ix", "ic"])
@pytest.mark.parametrize("mode", [Mode.FTL, Mode.BASE_H, Mode.BASE_Z], ids=lambda m: m.name)
def test_encode_pipelined_equals_qb3_tpu(mode, index):
    batches = _batches(3, 3, seed=int(mode) * 7)
    outs = list(pipeline.encode_tiles_pipelined(iter(batches), mode=mode, index=index,
                                                device=CPU))
    assert len(outs) == 3
    assert outs == list(jpipeline.encode_tiles_pipelined(iter(batches), mode=mode, index=index))
    _round_trips(outs, batches)


def test_encode_pipelined_u16_equals_qb3_tpu():
    batches = _batches(3, 2, seed=40, dtype=np.uint16, mult=181)
    outs = list(pipeline.encode_tiles_pipelined(iter(batches), index="ic", device=CPU))
    assert outs == list(jpipeline.encode_tiles_pipelined(iter(batches), index="ic"))
    _round_trips(outs, batches)
    decs = list(pipeline.decode_tiles_pipelined(iter(outs), device=CPU))
    for d, b in zip(decs, batches):
        assert d.dtype == np.uint16
        np.testing.assert_array_equal(d, b)


def test_pipelined_keeps_qb3_tpus_curve_and_header():
    """qb3_tpu's pipeline walks the Hilbert curve and writes order 0 into
    the header whatever the mode: a BASE_Z stream differs from the one-shot
    encode's and names the Hilbert curve; BASE_H equals the one-shot's."""
    tiles = _batches(1, 2, seed=60)[0]
    for mode, same in ((Mode.BASE_Z, False), (Mode.BASE_H, True)):
        streams = next(pipeline.encode_tiles_pipelined(iter([tiles]), mode=mode, device=CPU))
        for s, t in zip(streams, tiles):
            assert (s == qb3_tpu.encode(t, mode=mode)) is same
            assert container.parse_headers(s).order == HILBERT
            assert container.parse_headers(qt.encode(t, mode=mode, device=CPU)).order == \
                (ZCURVE if mode == Mode.BASE_Z else HILBERT)
            np.testing.assert_array_equal(qt.decode(s, device=CPU)[0], t)


@pytest.mark.parametrize("index", [False, True, "ic"], ids=["none", "ix", "ic"])
def test_cf_h_pipelined_round_trips(index):
    """CF_H: qb3_tpu's pipeline writes fast-mode codes behind the CF_H mode
    byte; the port writes the same bytes, and both packages decode them to
    the tiles."""
    batches = _batches(2, 2, seed=70)
    outs = list(pipeline.encode_tiles_pipelined(iter(batches), mode=Mode.CF_H, index=index,
                                                device=CPU))
    assert outs == list(jpipeline.encode_tiles_pipelined(iter(batches), mode=Mode.CF_H,
                                                         index=index))
    _round_trips(outs, batches)
    for s, t in zip(outs[0], batches[0]):
        np.testing.assert_array_equal(qb3_tpu.decode(s)[0], t)


@pytest.mark.parametrize("order,fallback", [(("smooth", "noisy", "smooth"), False),
                                            (("smooth", "smooth", "noisy"), True)],
                         ids=["smooth-noisy-smooth", "smooth-smooth-noisy"])
def test_fetch_cap_and_fallback(order, fallback, monkeypatch):
    """The third batch's fetch cap comes from the first batch's worst tile;
    a noisy third batch passes it, and its words come from the retained
    full buffer (the width encode_finish sees), to qb3_tpu's bytes."""
    rng = np.random.default_rng(3)
    kinds = {
        "smooth": np.stack([np.zeros((64, 64, 1), np.uint8) for _ in range(2)]),
        # noisy but compressible (no stored fallback, ratio ~100%)
        "noisy": np.stack([(rng.integers(0, 2, (64, 64, 1)) * 120
                            + rng.integers(0, 60, (64, 64, 1))).astype(np.uint8)
                           for _ in range(2)]),
    }
    batches = [kinds[k] for k in order]
    widths = []
    finish = pipeline.encode_finish
    monkeypatch.setattr(pipeline, "encode_finish",
                        lambda plan, words, host: widths.append(words.shape[1])
                        or finish(plan, words, host))
    outs = list(pipeline.encode_tiles_pipelined(iter(batches), index="ic", device=CPU))
    assert outs == list(jpipeline.encode_tiles_pipelined(iter(batches), index="ic"))
    _round_trips(outs, batches)
    n_words = qt.api.stream_words(64, 64, 1, 0)
    assert widths[:2] == [n_words, n_words]  # no cap before a batch has finished
    assert (widths[2] == n_words) is fallback


def _sidecar_batches(kind):
    batches = _batches(3, 3, seed={"ic": 80, "ix": 90, "ib": 100}[kind])
    if kind == "ib":
        return batches, [j_encode_tiles(b, mode=Mode.CF_H, index=True) for b in batches]
    return batches, [qt.encode_tiles(b, index=True if kind == "ix" else "ic", device=CPU)
                     for b in batches]


@pytest.mark.parametrize("kind", ["ic", "ix", "ib"])
def test_decode_pipelined_equals_qb3_tpu(kind):
    batches, streams = _sidecar_batches(kind)
    decs = list(pipeline.decode_tiles_pipelined(iter(streams), device=CPU))
    assert len(decs) == 3
    for d, j, b in zip(decs, jpipeline.decode_tiles_pipelined(iter(streams)), batches):
        np.testing.assert_array_equal(d, np.asarray(j))
        np.testing.assert_array_equal(d, b)


def test_decode_pipelined_raises_on_mixed_shapes():
    a = qt.encode(corpus.natural8(64, 64, 3, seed=1), index=True, device=CPU)
    b = qt.encode(corpus.natural8(32, 64, 3, seed=2), index=True, device=CPU)
    with pytest.raises(QB3ShapeError, match="same-shape"):
        list(pipeline.decode_tiles_pipelined(iter([[a, b]]), device=CPU))


def test_decode_pipelined_raises_without_sidecar():
    s = qt.encode(corpus.natural8(64, 64, 3, seed=3), device=CPU)
    with pytest.raises(QB3ShapeError, match="sidecar"):
        list(pipeline.decode_tiles_pipelined(iter([[s]]), device=CPU))
