"""The image-layout fast encode of qb3_tpu_torch (the encode of u16, u32
and u64 images whose sides are multiples of 4) against qb3_tpu, on the CPU:
the image-layout phase A (qb3_tpu_torch.ops.encode_image) against
qb3_tpu.ops.encode_image, K8's plain twin against the Pallas kernel
encode_pack_image in interpret mode, and fused_encode against the block
encode (fast_encode) and qb3_tpu's bytes.

Same seeded inputs through both packages; the tolerance is zero: planes,
rungs, lengths, words and bytes are equal integers.
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qb3_tpu
import qb3_tpu_torch as qt
from qb3_tpu.ops import encode as jencode
from qb3_tpu.ops import encode_image as jencode_image
from qb3_tpu.ops.encode_pallas import encode_pack_image as j_encode_pack_image
from qb3_tpu_torch import api
from qb3_tpu_torch.api import fast_encode, fused_encode, stream_words, to_carrier
from qb3_tpu_torch.benchutil import WIDE_IMAGES, WIDE_SHA256, headline_image, wide_image
from qb3_tpu_torch.constants import HILBERT, ZCURVE, Mode
from qb3_tpu_torch.ops import encode_cuda
from qb3_tpu_torch.ops.bitpack import group_bits_bound
from qb3_tpu_torch.ops.encode_image import phase_a_image

from . import corpus, pack_edges

# one compile per shape instead of op-by-op dispatch
j_phase_a_image = jax.jit(jencode_image.phase_a_image,
                          static_argnames=("order", "cband", "skipstep"))
j_encode_fast_blocks = jax.jit(jencode.encode_fast_blocks,
                               static_argnames=("order", "cband", "skipstep"))
DTYPE_CODE = {np.uint16: 2, np.uint32: 4, np.uint64: 6}


def _full_range_u64(h, w, nb, seed):
    """Full-range u64 noise: blocks at rung 63, the 65-bit long code."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 64, (h, w, nb), dtype=np.uint64, endpoint=False)


# name -> (image, order, cband, skipstep): u16/u32/u64, FTL and BASE, both
# curves, 1, 3 and 4 bands, low rungs (the group-context swap) and rung 63
CASES = {
    "u16-ftl-h-1band": (lambda: headline_image(16, 24, 1, seed=1, dtype=np.uint16),
                        HILBERT, (0,), True),
    "u16-base-z-3band": (lambda: headline_image(12, 16, 3, seed=2, dtype=np.uint16),
                         ZCURVE, (1, 1, 1), False),
    "i16-ftl-h": (lambda: (corpus.natural8(8, 20, 1, seed=3).astype(np.int16) - 100)
                  .view(np.uint16), HILBERT, (0,), True),
    "u32-base-h-4band": (lambda: corpus.to_type(corpus.natural8(16, 12, 4, seed=4),
                                                np.uint32, 65537),
                         HILBERT, (1, 1, 1, 3), False),
    "u32-ftl-z-4band": (lambda: headline_image(8, 8, 4, seed=5, dtype=np.uint32),
                        ZCURVE, (0, 1, 2, 3), True),
    "u64-ftl-h": (lambda: headline_image(12, 16, 1, seed=6, dtype=np.uint64),
                  HILBERT, (0,), True),
    "u64-rung63-base-z": (lambda: _full_range_u64(8, 8, 1, seed=7), ZCURVE, (0,), False),
    "u64-rung63-base-h-3band": (lambda: _full_range_u64(8, 4, 3, seed=8), HILBERT,
                                (1, 1, 1), False),
}


def _entry_state(img, seed):
    """Non-zero band state, made with numpy."""
    nb, tbits = img.shape[-1], img.dtype.itemsize * 8
    rng = np.random.default_rng(seed)
    prev = rng.integers(0, 1 << min(tbits, 63), nb, dtype=np.uint64).astype(img.dtype)
    return prev, rng.integers(0, tbits // 2, nb).astype(np.int32)


def _port_phase_a(img, prev, runbits, order, cband, skipstep):
    return phase_a_image(to_carrier(img, "cpu"), to_carrier(prev, "cpu"),
                         torch.from_numpy(runbits), order, cband, skipstep,
                         img.dtype.itemsize * 8)


def _u64(t):
    return t.numpy().view(np.uint64) if t.dtype == torch.int64 else t.numpy().astype(np.uint64)


@pytest.mark.parametrize("name", list(CASES))
def test_phase_a_image_matches(name):
    make, order, cband, skipstep = CASES[name]
    img = make()
    tbits = img.dtype.itemsize * 8
    prev, runbits = _entry_state(img, seed=len(name))
    j = j_phase_a_image(jnp.asarray(img), jnp.asarray(prev), jnp.asarray(runbits), order,
                        cband, skipstep)
    t = _port_phase_a(img, prev, runbits, order, cband, skipstep)
    m = _u64(t["m"])
    np.testing.assert_array_equal(m & np.uint64(0xFFFFFFFF), np.asarray(j["m_lo"]))
    if tbits == 64:
        np.testing.assert_array_equal(m >> np.uint64(32), np.asarray(j["m_hi"]))
    else:
        assert j["m_hi"] is None and not (m >> np.uint64(tbits)).any()
    for key in ("rung", "gkind", "prefix_code", "prefix_len", "exit_runbits"):
        np.testing.assert_array_equal(_u64(t[key]), np.asarray(j[key]).astype(np.uint64),
                                      err_msg=key)
    # qb3_tpu's u16 decorrelation wraps at 32 bits; the band state is the
    # low tbits
    mask = np.uint64((1 << tbits) - 1) if tbits < 64 else ~np.uint64(0)
    np.testing.assert_array_equal(_u64(t["exit_prev"]),
                                  np.asarray(j["exit_prev"]).astype(np.uint64) & mask)
    # glen against the lengths the block-layout encoder emits (qb3_tpu's
    # image-layout glen misses the swap: test_glen_counts_the_swapped_codes)
    _, lens, _, _ = j_encode_fast_blocks(jnp.asarray(img), jnp.asarray(prev),
                                         jnp.asarray(runbits), order, cband, skipstep)
    np.testing.assert_array_equal(_u64(t["glen"]),
                                  np.asarray(lens).astype(np.uint64).sum(-1))
    if "rung63" in name:
        assert int(t["rung"].max()) == 63


def test_glen_counts_the_swapped_codes():
    """The group-context swap of rungs 1..7 trades a nominal code for a long
    one (2^r-1 <-> 2^r), so a group's length changes when the two values are
    not equally frequent.  qb3_tpu's value_lens_planes measures the value
    before the swap; the port measures the code emitted, as the block-layout
    encoder does (ROADMAP.md Queue 3)."""
    img = np.random.default_rng(9).integers(0, 20, (16, 16, 1)).astype(np.uint16)
    zero, zrun = np.zeros(1, np.uint16), np.zeros(1, np.int32)
    j = j_phase_a_image(jnp.asarray(img), jnp.asarray(zero), jnp.asarray(zrun), HILBERT,
                        (0,), True)
    _, lens, _, _ = j_encode_fast_blocks(jnp.asarray(img), jnp.asarray(zero),
                                         jnp.asarray(zrun), HILBERT, (0,), True)
    want = np.asarray(lens).astype(np.int64).sum(-1)
    assert not np.array_equal(np.asarray(j["glen"]).astype(np.int64), want)
    t = _port_phase_a(img, zero, zrun, HILBERT, (0,), True)
    np.testing.assert_array_equal(t["glen"].numpy(), want)


def _n_words(img):
    """The encoder's stream buffer in words, as api.Encoder sizes it."""
    h, w, nb = img.shape
    return stream_words(w, h, nb, DTYPE_CODE[img.dtype.type])


def _k8_args(o, img, order):
    return encode_cuda.image_pack_args(o, img.dtype.itemsize * 8, _n_words(img), order)


# the Pallas kernel takes (W/4 * C) % 128 == 0: one block row per grid tile
K8_CASES = {
    "u16-8x512x1-ftl-h": (lambda: headline_image(8, 512, 1, seed=10, dtype=np.uint16),
                          HILBERT, (0,), True),
    "u32-8x128x4-base-h": (lambda: headline_image(8, 128, 4, seed=11, dtype=np.uint32),
                           HILBERT, (1, 1, 1, 3), False),
    "u64-8x512x1-ftl-z": (lambda: headline_image(8, 512, 1, seed=12, dtype=np.uint64),
                          ZCURVE, (0,), True),
    "u64-12x128x4-base-h": (lambda: headline_image(12, 128, 4, seed=13, dtype=np.uint64),
                            HILBERT, (0, 1, 2, 3), False),
    "u64-rung63-8x128x4-ftl-h": (lambda: _full_range_u64(8, 128, 4, seed=14), HILBERT,
                                 (0, 1, 2, 3), True),
}


@pytest.mark.parametrize("name", list(K8_CASES))
def test_k8_twin_matches_pallas_kernel_interpret(name):
    """The same phase-A outputs through K8's twin and the Pallas kernel."""
    make, order, cband, skipstep = K8_CASES[name]
    img = make()
    prev, runbits = _entry_state(img, seed=len(name))
    args = _k8_args(_port_phase_a(img, prev, runbits, order, cband, skipstep), img, order)
    m, rung, gkind, pcode, plen, glen, tbits, n_words, _ = args
    before = encode_cuda.encode_pack_image.launches
    words, total, glen32 = encode_cuda.encode_pack_image(*args)
    assert encode_cuda.encode_pack_image.launches == before  # CPU: the twin
    mu = _u64(m)
    i32 = lambda x: jnp.asarray(x.numpy().astype(np.int32))  # noqa: E731
    jw, jt, jg = j_encode_pack_image(
        jnp.asarray((mu & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
        jnp.asarray((mu >> np.uint64(32)).astype(np.uint32)) if tbits == 64 else None,
        i32(rung), i32(gkind), jnp.asarray(pcode.numpy().astype(np.uint32)), i32(plen),
        i32(glen), tbits, n_words, group_bits_bound(tbits, best=False), m.shape[1] // 4,
        m.shape[2], order,
        interpret=True)
    nw = (int(jt) + 31) // 32
    assert int(total) == int(jt)
    np.testing.assert_array_equal(glen32.numpy(), np.asarray(jg).astype(np.int32))
    np.testing.assert_array_equal(words.numpy().view(np.uint32)[:nw], np.asarray(jw)[:nw])
    if "rung63" in name:
        assert int(rung.max()) == 63


@pytest.mark.parametrize("name", list(pack_edges.K8_SMALL))
def test_k8_twin_edges_match_pallas_kernel_interpret(name):
    """K8's twin against the Pallas kernel on small versions of the inputs
    that can break the CUDA kernel (tests/pack_edges.py) that the Pallas
    kernel's shape rule admits: 1, 3, 8 and 13 bands, a block of zero-length
    groups, block edges at every bit phase, truncation."""
    img = pack_edges.k8_image(name, small=True)
    prev, runbits = _entry_state(img, seed=len(name))
    args = list(_k8_args(_port_phase_a(img, prev, runbits, HILBERT,
                                       tuple(api.default_cband(img.shape[2])), True),
                         img, HILBERT))
    fields = [args[i].numpy().copy() for i in (2, 3, 4, 5)]  # gkind, pcode, plen, glen
    pack_edges.k8_edit(name, *fields)
    args[2:6] = [torch.from_numpy(f) for f in fields]
    args[7] = pack_edges.k8_n_words(name, fields[3], args[7])
    m, rung, gkind, pcode, plen, glen, tbits, n_words, _ = args
    words, total, glen32 = encode_cuda.encode_pack_image(*args)
    mu = _u64(m)
    i32 = lambda x: jnp.asarray(x.numpy().astype(np.int32))  # noqa: E731
    jw, jt, jg = j_encode_pack_image(
        jnp.asarray((mu & np.uint64(0xFFFFFFFF)).astype(np.uint32)), None, i32(rung),
        i32(gkind), jnp.asarray(pcode.numpy().astype(np.uint32)), i32(plen), i32(glen), tbits,
        n_words, group_bits_bound(tbits, best=False), m.shape[1] // 4, m.shape[2], HILBERT,
        interpret=True)
    nw = min(n_words, (int(jt) + 31) // 32)
    assert int(total) == int(jt)
    np.testing.assert_array_equal(glen32.numpy(), np.asarray(jg).astype(np.int32))
    np.testing.assert_array_equal(words.numpy().view(np.uint32)[:nw], np.asarray(jw)[:nw])
    assert not words[nw:].any()
    if name == "truncated":
        assert int(total) > 32 * n_words


def test_k8_twin_checks_its_inputs():
    img = headline_image(8, 12, 2, seed=15, dtype=np.uint32)
    zero, zrun = np.zeros(2, np.uint32), np.zeros(2, np.int32)
    args = list(_k8_args(_port_phase_a(img, zero, zrun, HILBERT, (0, 1), True), img,
                         HILBERT))
    with pytest.raises(ValueError, match="disagree with glen"):
        encode_cuda.encode_pack_image(*args[:5], args[5] + 1, *args[6:])
    with pytest.raises(ValueError, match="multiples of 4"):
        encode_cuda.encode_pack_image(args[0][:, :10], *args[1:])
    with pytest.raises(ValueError, match="one per group"):
        encode_cuda.encode_pack_image(args[0], args[1][:-1], *args[2:])


# name -> (image, mode, cband): shapes qb3_tpu's fused branch refuses
# ((W/4 * C) % 128 != 0) among them
FUSED_CASES = {
    "u16-16x20x3-ftl": (lambda: headline_image(16, 20, 3, seed=16, dtype=np.uint16),
                        Mode.FTL, None),
    "u16-lowrung-base-h": (lambda: np.random.default_rng(17).integers(0, 20, (12, 16, 1))
                           .astype(np.uint16), Mode.BASE_H, None),
    "u32-8x12x4-base-z": (lambda: headline_image(8, 12, 4, seed=18, dtype=np.uint32),
                          Mode.BASE_Z, [0, 1, 2, 3]),
    "i64-ftl": (lambda: (corpus.natural8(12, 8, 1, seed=19).astype(np.int64)
                         * -(1 << 30)).astype(np.int64), Mode.FTL, None),
    "u64-rung63-base-h": (lambda: _full_range_u64(8, 8, 2, seed=20), Mode.BASE_H, None),
}


@pytest.mark.parametrize("name", list(FUSED_CASES))
def test_fused_encode_matches_default(name, monkeypatch):
    make, mode, cband = FUSED_CASES[name]
    img = make()
    h, w, nb = img.shape
    uns = img.view({2: np.uint16, 4: np.uint32, 8: np.uint64}[img.dtype.itemsize])
    tbits = uns.dtype.itemsize * 8
    prev, runbits = _entry_state(uns, seed=len(name))
    order = ZCURVE if mode == Mode.BASE_Z else HILBERT
    cb = tuple(cband or api.default_cband(nb))
    args = (to_carrier(uns, "cpu"), to_carrier(prev, "cpu"), torch.from_numpy(runbits),
            order, cb, mode == Mode.FTL, tbits, _n_words(uns))
    got, want = fused_encode(*args), fast_encode(*args)
    for what, a, b in zip(("words", "total", "exit_prev", "exit_runbits", "glen", "rung"),
                          got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), what
    # framed: the public encode takes fused_encode for these shapes, every sidecar
    calls = _count_calls(monkeypatch, "fused_encode")
    for index in (False, True, "ic"):
        stream = qt.encode(img, mode=mode, coreband=cband, index=index, device="cpu")
        assert stream == qb3_tpu.encode(img, mode=mode, coreband=cband, index=index)
    assert calls == [3]


def _count_calls(monkeypatch, name):
    """Count the calls of api.<name> in a one-item list."""
    calls, fn = [0], getattr(api, name)

    def counted(*args, **kwargs):
        calls[0] += 1
        return fn(*args, **kwargs)

    monkeypatch.setattr(api, name, counted)
    return calls


# name -> (image, takes the image-layout encode)
DISPATCH_CASES = {
    "u16-16x24x2": (lambda: headline_image(16, 24, 2, seed=21, dtype=np.uint16), True),
    "i32-8x4x1": (lambda: headline_image(8, 4, 1, seed=22, dtype=np.uint32)
                  .view(np.int32), True),
    "u64-3x40x1-small": (lambda: headline_image(3, 40, 1, seed=23, dtype=np.uint64), True),
    "u16-18x20x1": (lambda: headline_image(18, 20, 1, seed=24, dtype=np.uint16), False),
    "u32-16x22x3": (lambda: headline_image(16, 22, 3, seed=25, dtype=np.uint32), False),
    "u8-16x24x3": (lambda: headline_image(16, 24, 3, seed=26), False),
}


@pytest.mark.parametrize("name", list(DISPATCH_CASES))
def test_public_encode_picks_the_path_by_shape(name, monkeypatch):
    """The public encode takes fused_encode exactly for u16/u32/u64 images
    whose (repacked) sides are multiples of 4, on any device; the bytes are
    qb3_tpu's either way."""
    make, fused = DISPATCH_CASES[name]
    img = make()
    n_fused = _count_calls(monkeypatch, "fused_encode")
    n_block = _count_calls(monkeypatch, "fast_encode")
    for index in (False, True):
        assert qt.encode(img, index=index, device="cpu") == qb3_tpu.encode(img, index=index)
    assert (n_fused, n_block) == (([2], [0]) if fused else ([0], [2]))


@pytest.mark.parametrize("label", list(WIDE_IMAGES))
def test_wide_sha256(label, monkeypatch):
    """The constants chip_smoke.py checks on the card, re-derived from
    qb3_tpu, the port's public encode (the image-layout path) and its block
    encode."""
    img = wide_image(label)
    stream = qb3_tpu.encode(img, index=True)
    assert hashlib.sha256(stream).hexdigest() == WIDE_SHA256[label]
    assert qt.encode(img, index=True, device="cpu") == stream
    monkeypatch.setattr(api, "takes_fused", lambda *shape: False)
    assert qt.encode(img, index=True, device="cpu") == stream
