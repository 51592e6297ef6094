"""qb3_tpu_torch.lite, the NumPy-only client decoder, against
qb3_tpu.lite.decode on streams of every mode, the wide and signed types,
quanta and small images (the STORED bypass and the repacked 3-row ones).
The tolerance is zero: arrays and stream infos are equal."""

import numpy as np
import pytest

import qb3_tpu
from qb3_tpu import lite as jlite
from qb3_tpu_torch import lite
from qb3_tpu_torch.constants import Mode

from . import corpus


def _same(stream, img=None):
    out, info = lite.decode(stream)
    ref, jinfo = jlite.decode(stream)
    assert out.dtype == ref.dtype
    np.testing.assert_array_equal(out, ref)
    assert (info.mode, info.order, info.quanta) == (jinfo.mode, jinfo.order, jinfo.quanta)
    if img is not None:
        np.testing.assert_array_equal(out, img)


@pytest.mark.parametrize("mode", [Mode.FTL, Mode.BASE_H, Mode.BASE_Z, Mode.RLE_H, Mode.RLE,
                                  Mode.CF_H, Mode.CF, Mode.CF_RLE_H, Mode.CF_RLE],
                         ids=lambda m: m.name)
def test_lite_equals_qb3_tpus_every_mode(mode):
    img = corpus.natural8(48, 40, 3, seed=240)
    _same(qb3_tpu.encode(img, mode=mode), img)


@pytest.mark.parametrize("dtype,mult", [(np.uint16, 5), (np.int16, -3), (np.uint32, 65537),
                                        (np.int32, -70001), (np.uint64, 1 << 56),
                                        (np.int64, -(1 << 40))],
                         ids=["u16", "i16", "u32", "i32", "u64", "i64"])
def test_lite_wide_types(dtype, mult):
    img = corpus.to_type(corpus.natural8(32, 32, 1, seed=241), dtype, mult)
    for mode in (Mode.FTL, Mode.CF_H):
        _same(qb3_tpu.encode(img, mode=mode), img)


def test_lite_quanta_and_small():
    img = corpus.natural8(32, 32, 1, seed=242)
    _same(qb3_tpu.encode(img, mode=Mode.FTL, quanta=4))
    _same(qb3_tpu.encode(img, mode=Mode.FTL, quanta=3, away=True))
    for shape in ((3, 9, 1), (2, 2, 1), (13, 3, 2)):  # repacked and stored
        tiny = corpus.natural8(*shape, seed=243)
        _same(qb3_tpu.encode(tiny, mode=Mode.FTL), tiny)
