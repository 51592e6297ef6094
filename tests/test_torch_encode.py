"""Phase A (qb3_tpu_torch.ops.encode) and K1's plain twin
(qb3_tpu_torch.ops.bitpack.pack_groups) against qb3_tpu, on the CPU.

Same seeded inputs through both packages; the tolerance is zero: codes,
lengths, exit state, rungs and packed words are equal integers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qb3_tpu.api import max_encoded_size
from qb3_tpu.ops import bitpack as jbitpack
from qb3_tpu.ops import encode as jencode
from qb3_tpu_torch.api import to_carrier
from qb3_tpu_torch.constants import HILBERT, ZCURVE
from qb3_tpu_torch.ops import bitpack, pack_cuda
from qb3_tpu_torch.ops.encode import encode_fast_blocks

from . import corpus, pack_edges

# one compile per shape instead of op-by-op dispatch
j_encode_fast_blocks = jax.jit(
    jencode.encode_fast_blocks,
    static_argnames=("order", "cband", "skipstep", "with_rungs", "lanewise"))


def _u64_spikes():
    img = corpus.natural8(32, 32, 1, seed=83).astype(np.uint64)
    for i, s in enumerate([1 << 63, (1 << 63) | (1 << 62), (1 << 64) - 1, 1 << 62]):
        img[4 * i, 0, 0] = s
    return img


# name -> (image, order, cband, skipstep): every width, FTL and BASE, both
# curves, signed views, aligned and unaligned shapes
CASES = {
    "u8-rgb-ftl": (lambda: corpus.natural8(32, 24, 3, seed=1), HILBERT, (1, 1, 1), True),
    "u8-unaligned-base": (lambda: corpus.natural8(21, 27, 2, seed=2), HILBERT, (0, 1), False),
    "u16-base-z": (lambda: corpus.to_type(corpus.natural8(24, 20, 1, seed=3), np.uint16, 300),
                   ZCURVE, (0,), False),
    "i16-ftl": (lambda: (corpus.natural8(20, 24, 1, seed=4).astype(np.int16) - 100)
                .view(np.uint16), HILBERT, (0,), True),
    "u32-unaligned-ftl": (lambda: corpus.to_type(corpus.natural8(18, 22, 1, seed=5),
                                                 np.uint32, 65537), HILBERT, (0,), True),
    "u64-rung63-base": (_u64_spikes, HILBERT, (0,), False),
    "i64-ftl": (lambda: (corpus.natural8(16, 16, 1, seed=6).astype(np.int64)
                         * -(1 << 30)).view(np.uint64), HILBERT, (0,), True),
}


def _phase_a_both(img, order, cband, skipstep, seed=0, lanewise=None):
    """(JAX outputs, port outputs) as numpy, from the same non-zero entry state."""
    nb = img.shape[-1]
    tbits = img.dtype.itemsize * 8
    rng = np.random.default_rng(seed)
    prev = rng.integers(0, 1 << min(tbits, 63), nb, dtype=np.uint64).astype(img.dtype)
    runbits = rng.integers(0, tbits // 2, nb).astype(np.int32)
    j = j_encode_fast_blocks(jnp.asarray(img), jnp.asarray(prev), jnp.asarray(runbits),
                             order, cband, skipstep, with_rungs=True, lanewise=lanewise)
    t = encode_fast_blocks(to_carrier(img, "cpu"), to_carrier(prev, "cpu"),
                           torch.from_numpy(runbits), order, cband, skipstep, tbits,
                           with_rungs=True, lanewise=lanewise)
    j = [np.asarray(x).astype(np.uint64) for x in j]
    t = [x.numpy().view(np.uint64) if x.dtype == torch.int64 else
         x.numpy().astype(np.uint64) for x in t]
    return j, t


@pytest.mark.parametrize("name", list(CASES))
def test_phase_a_matches(name):
    make, order, cband, skipstep = CASES[name]
    j, t = _phase_a_both(make(), order, cband, skipstep)
    for what, a, b in zip(("codes", "lens", "exit_prev", "exit_runbits", "rung"), j, t):
        np.testing.assert_array_equal(b, a, err_msg=what)


@pytest.mark.parametrize("lanewise", [False, True])
def test_delta_forms_match(lanewise):
    j, t = _phase_a_both(corpus.natural8(24, 32, 2, seed=7), HILBERT, (0, 1), True,
                         seed=3, lanewise=lanewise)
    for a, b in zip(j, t):
        np.testing.assert_array_equal(b, a)


def test_batch_axis_matches_single_images():
    """Leading tile axis (the JAX package's vmap) with fresh state per tile."""
    tiles = np.stack([corpus.natural8(16, 20, 3, seed=10 + i) for i in range(3)])
    zero = torch.zeros(3, 3, dtype=torch.int64)
    codes, lens, _, _, rung = encode_fast_blocks(
        to_carrier(tiles, "cpu"), zero, zero, HILBERT, (1, 1, 1), True, 8,
        with_rungs=True, lanewise=True)
    for i in range(3):
        jc, jl, _, _, jr = j_encode_fast_blocks(
            jnp.asarray(tiles[i]), jnp.zeros(3, jnp.uint8), jnp.zeros(3, jnp.int32),
            HILBERT, (1, 1, 1), True, with_rungs=True, lanewise=True)
        np.testing.assert_array_equal(codes[i].numpy(), np.asarray(jc))
        np.testing.assert_array_equal(lens[i].numpy(), np.asarray(jl))
        np.testing.assert_array_equal(rung[i].numpy(), np.asarray(jr))


def _codes_lens(name):
    make, order, cband, skipstep = CASES[name]
    img = make()
    h, w, nb = img.shape
    tbits = img.dtype.itemsize * 8
    zero = np.zeros(nb, img.dtype)
    jc, jl, _, _ = j_encode_fast_blocks(jnp.asarray(img), jnp.asarray(zero),
                                        jnp.zeros(nb, jnp.int32), order, cband, skipstep)
    tc, tl, _, _ = encode_fast_blocks(to_carrier(img, "cpu"), to_carrier(zero, "cpu"),
                                      torch.zeros(nb, dtype=torch.int32), order, cband,
                                      skipstep, tbits)
    n_words = (max_encoded_size(w, h, nb, {8: 0, 16: 2, 32: 4, 64: 6}[tbits]) + 3) // 4 + 2
    return jc, jl, tc, tl, n_words, jbitpack.group_bits_bound(tbits, best=False)


@pytest.mark.parametrize("name", ["u8-rgb-ftl", "u16-base-z", "u32-unaligned-ftl",
                                  "u64-rung63-base"])
def test_pack_twin_matches(name):
    jc, jl, tc, tl, n_words, maxbits = _codes_lens(name)
    jw, jt, jg = jbitpack.pack_groups(jc, jl, n_words, maxbits)
    before = pack_cuda.pack_groups_chunked.launches
    tw, tt, tg = pack_cuda.pack_groups_chunked(tc, tl, n_words, maxbits)
    assert pack_cuda.pack_groups_chunked.launches == before  # CPU: the twin
    assert int(tt) == int(jt)
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg).astype(np.int32))
    np.testing.assert_array_equal(tw.numpy().view(np.uint32), np.asarray(jw))


def test_pack_twin_matches_pallas_kernel_interpret():
    from qb3_tpu.ops.pack_pallas import pack_groups_chunked

    jc, jl, tc, tl, n_words, maxbits = _codes_lens("u8-rgb-ftl")
    jw, jt, jg = pack_groups_chunked(jc, jl, n_words, maxbits, interpret=True)
    tw, tt, tg = bitpack.pack_groups(tc, tl, n_words, maxbits)
    nw = (int(jt) + 31) // 32
    assert int(tt) == int(jt)
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg).astype(np.int32))
    np.testing.assert_array_equal(tw.numpy().view(np.uint32)[:nw], np.asarray(jw)[:nw])


@pytest.mark.parametrize("name", list(pack_edges.K1_CASES))
def test_pack_twin_edges_match_pallas_kernel_interpret(name):
    """K1's twin against the Pallas kernel on small versions of the inputs
    that can break the CUDA kernel's block scan, look-back and stores
    (tests/pack_edges.py): one group, a ragged group count, several tiles
    (the Pallas kernel packs one a call), a block of zero-length groups,
    block edges at several bit phases, truncation and 65-bit codes."""
    from qb3_tpu.ops.pack_pallas import pack_groups_chunked

    codes, lens, n_words = pack_edges.k1_case(name, small=True)
    maxbits = -(-int(lens.astype(np.int64).sum(-1).max()) // 64) * 64
    tw, tt, tg = bitpack.pack_groups(torch.from_numpy(codes.view(np.int64)),
                                     torch.from_numpy(lens), n_words, maxbits)
    wide = int(lens.max()) > 32
    for t in range(codes.shape[0]):
        jc = codes[t] if wide else codes[t].astype(np.uint32)
        jw, jt, jg = pack_groups_chunked(jnp.asarray(jc), jnp.asarray(lens[t]), n_words, maxbits,
                                         interpret=True)
        nw = min(n_words, (int(jt) + 31) // 32)
        assert int(tt[t]) == int(jt)
        np.testing.assert_array_equal(tg[t].numpy(), np.asarray(jg).astype(np.int32))
        np.testing.assert_array_equal(tw[t].numpy().view(np.uint32)[:nw], np.asarray(jw)[:nw])
        assert not tw[t, nw:].any()
    if name.endswith("truncated"):
        assert int(tt[0]) > 32 * n_words
