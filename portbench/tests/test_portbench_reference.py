"""The benchmark's plain reference (portbench/reference/qb3ref.py) on the CPU.

The pins were computed with the JAX package and are re-derived here at the
benchmark's own sizes: the headline raster's FTL "ic" stream, the Landsat
sample's decoded raster and its CF_H stream.  Round trips and equality
with the port's CPU path (its kernels' plain twins) cover the other group
kinds, shapes and band counts at small sizes.

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


CASES = [(dt, shape) for dt in (np.uint8, np.uint16)
         for shape in ((16, 16, 1), (24, 40, 3), (32, 16, 8))]


@pytest.mark.parametrize("dtype,shape", CASES, ids=lambda x: getattr(x, "__name__", str(x)))
@pytest.mark.parametrize("mode,index", [(qb3ref.FTL, "ic"), (qb3ref.FTL, None),
                                        (qb3ref.BASE_H, None), (qb3ref.CF_H, None)])
def test_round_trip(dtype, shape, mode, index):
    for name, img in _rasters(dtype, *shape, seed=sum(shape) + mode).items():
        assert np.array_equal(qb3ref.decode(qb3ref.encode(img, mode, index)), img), name


@pytest.mark.parametrize("dtype,shape", CASES, ids=lambda x: getattr(x, "__name__", str(x)))
@pytest.mark.parametrize("mode,index", [(qb3ref.FTL, "ic"), (qb3ref.CF_H, None)])
def test_matches_port_on_cpu(dtype, shape, mode, index):
    """Byte for byte the port's streams (its CPU path) at small sizes, and
    the port's streams decode to their rasters by the reference."""
    q = pytest.importorskip("qb3_tpu_torch")
    for name, img in _rasters(dtype, *shape, seed=sum(shape) + 7 * mode).items():
        port = q.encode(img, mode=mode, index=index or False, device="cpu")
        assert qb3ref.encode(img, mode, index) == port, name
        assert np.array_equal(qb3ref.decode(port), img), name


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
