"""The host modules qb3_tpu_torch copies from qb3_tpu (constants, tables,
container, rle) give the same values and bytes, and importing the port
loads neither jax nor qb3_tpu."""

import subprocess
import sys

import numpy as np
import pytest

from qb3_tpu import constants as jconstants
from qb3_tpu import container as jcontainer
from qb3_tpu import rle as jrle
from qb3_tpu import tables as jtables
from qb3_tpu_torch import constants, container, rle, tables

TABLES = ["ENC_SINGLE", "ENC_GROUP", "DEC_SINGLE", "DEC_GROUP", "CSW", "DSW",
          "SIGNAL", "IDX_ENC", "IDX_DEC"]


@pytest.mark.parametrize("name", TABLES)
def test_tables_equal(name):
    np.testing.assert_array_equal(getattr(tables, name), getattr(jtables, name))


def test_constants_equal():
    assert (constants.B, constants.B2, constants.ZCURVE, constants.HILBERT,
            constants.TYPESIZES, constants.QB3_MAXBANDS_EXT) == (
        jconstants.B, jconstants.B2, jconstants.ZCURVE, jconstants.HILBERT,
        jconstants.TYPESIZES, jconstants.QB3_MAXBANDS_EXT)
    for enum in ("DType", "Mode", "Error"):
        assert {e.name: int(e) for e in getattr(constants, enum)} == \
            {e.name: int(e) for e in getattr(jconstants, enum)}
    for m in range(10):
        for f in ("is_fast_mode", "needs_rle", "is_best_mode", "mode_uses_zcurve"):
            assert getattr(constants, f)(m) == getattr(jconstants, f)(m)
    for order in (constants.ZCURVE, constants.HILBERT):
        assert constants.curve_offsets(order) == jconstants.curve_offsets(order)


@pytest.mark.parametrize("nbands,dtype,mode,quanta,order,index,sig", [
    (1, 0, 8, 1, 0, None, b"ix"),
    (3, 2, 4, 7, 0, b"\x01\x02" * 40, b"ic"),
    (3, 6, 0, 1, constants.ZCURVE, None, b"ix"),
    (5, 7, 8, 300, constants.HILBERT, b"\x05" * 70000, b"ix"),
    (2, 1, 255, 2, 0, None, b"ix"),
    (256, 4, 6, 1 << 20, 0, b"\x00\xff" * 10, b"ib"),
])
def test_headers_equal(nbands, dtype, mode, quanta, order, index, sig):
    cband = [(i + 1) % nbands if i % 2 else i for i in range(nbands)]
    args = (37, 19, nbands, dtype, mode, cband, quanta, order, index, sig)
    hdr = container.write_headers(*args)
    assert hdr == jcontainer.write_headers(*args)
    stream = hdr + b"\x00" * 16
    assert vars(container.parse_headers(stream)) == vars(jcontainer.parse_headers(stream))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rle_equal(seed):
    rng = np.random.default_rng(seed)
    # runs of zeros and 0xff amid literals: every escape rule fires
    parts = [rng.integers(0, 256, rng.integers(1, 9), dtype=np.uint8).tobytes()
             if k % 3 else bytes([0xFF * (k % 2)]) * int(rng.integers(2, 300))
             for k in range(200)]
    data = b"".join(parts)
    packed = rle.rle0_encode(data)
    assert packed == jrle.rle0_encode(data)
    assert rle.rle0_decoded_size(packed) == jrle.rle0_decoded_size(packed) == len(data)
    assert rle.rle0_decode(packed, len(data)) == data


def test_import_loads_no_jax():
    code = ("import sys, qb3_tpu_torch, qb3_tpu_torch.batch, qb3_tpu_torch.benchutil, "
            "qb3_tpu_torch._build, qb3_tpu_torch.ops.chunkwalk_cuda, "
            "qb3_tpu_torch.ops.pack_cuda; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'qb3_tpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
