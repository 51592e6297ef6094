"""The stitch of qb3_tpu_torch against qb3_tpu, on the CPU: K6's plain twin
(ops/place_cuda.place_slabs_plain) against the TPU kernel place_slabs run in
interpret mode and against the XLA placement of qb3_tpu's pack_groups, the
device stitch (stitch.stitch_words_device, K6's twin here) against qb3_tpu's
stitch_words_device and the host stitch_words, and the port's copies of the
NumPy stitch functions against qb3_tpu's.  Inputs are made with numpy from a
seed; the tolerance is zero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qb3_tpu import stitch as jstitch
from qb3_tpu.ops.pack_pallas import place_slabs as j_place_slabs
from qb3_tpu_torch import stitch
from qb3_tpu_torch.ops.place_cuda import place_slabs

M32 = (1 << 32) - 1


def _slabs(rng, ngroups: int, W: int, n0: int = 0):
    """Folded groups as a pack writes them: each group a random bit string
    of 0 .. 32 (W - 1) bits at the bit where the previous one ended (from bit
    n0), as W words from its base word -> (slab (ngroups, W) u32, base
    (ngroups,) int32 sorted, total bits).  Groups touch disjoint bits."""
    glen = rng.integers(0, 32 * (W - 1) + 1, ngroups)
    glen[rng.random(ngroups) < 0.1] = 0  # empty groups: slabs of zeros
    slab = np.zeros((ngroups, W), np.uint32)
    base = np.zeros(ngroups, np.int32)
    off = n0
    for g, n in enumerate(glen):
        bits = int.from_bytes(rng.bytes(4 * W), "little") & ((1 << int(n)) - 1)
        v = bits << (off & 31)
        slab[g] = [(v >> (32 * j)) & M32 for j in range(W)]
        base[g] = off >> 5
        off += int(n)
    return slab, base, off


def _place_xla(slab, base, n_words):
    """qb3_tpu's XLA placement (ops/bitpack.pack_groups)."""
    idx = jnp.asarray(base)[:, None] + jnp.arange(slab.shape[1], dtype=jnp.int32)[None, :]
    out = jnp.zeros((n_words,), dtype=jnp.uint32)
    return np.asarray(out.at[idx.reshape(-1)].add(jnp.asarray(slab).reshape(-1), mode="drop"))


def _k6(slab, base, n_words):
    before = place_slabs.launches
    got = place_slabs(torch.from_numpy(slab.view(np.int32)), torch.from_numpy(base), n_words)
    assert place_slabs.launches == before  # CPU: the twin
    return got.numpy().view(np.uint32)


@pytest.mark.parametrize("G,W,sub,seed", [(16, 4, 8, 0), (32, 9, 16, 1), (64, 32, 8, 2)])
def test_k6_twin_matches_pallas_kernel(G, W, sub, seed):
    """place_slabs_plain against the TPU kernel in interpret mode: 4 tiles
    of G groups at sorted word bases, starting mid-stream."""
    rng = np.random.default_rng(seed)
    ngroups = 4 * G
    slab, base, total = _slabs(rng, ngroups, W, n0=int(rng.integers(0, 5000)))
    span = max(int(base[t + G - 1] - (base[t] // 128) * 128) for t in range(0, ngroups, G))
    R = -(-(span + W + 128) // 128) * 128
    n_words = (total + 31) // 32
    want = np.asarray(j_place_slabs(jnp.asarray(slab), jnp.asarray(base), n_words, G, W, R,
                                    interpret=True, sub=sub))[0]
    got = _k6(slab, base, n_words)
    # the TPU kernel leaves words before the first tile's window and past
    # the stream's total unspecified
    lo = (int(base[0]) // 128) * 128
    np.testing.assert_array_equal(got[lo:], want[lo:n_words])
    assert not got[:int(base[0])].any()


@pytest.mark.parametrize("cut", [0, 1, 7])
def test_k6_twin_matches_xla_placement(cut):
    """place_slabs_plain against the XLA scatter-add, dropping the words
    past n_words (cut words short of the total)."""
    slab, base, total = _slabs(np.random.default_rng(10 + cut), 300, 6)
    n_words = (total + 31) // 32 - cut
    got = _k6(slab, base, n_words)
    np.testing.assert_array_equal(got, _place_xla(slab, base, n_words))
    if cut == 0:  # the sum of disjoint bits is their OR
        ors = np.zeros(n_words + 6, np.uint32)
        for g in range(base.size):
            ors[base[g]:base[g] + 6] |= slab[g]
        np.testing.assert_array_equal(got, ors[:n_words])


def test_k6_twin_unsorted_and_empty():
    rng = np.random.default_rng(3)
    slab, base, total = _slabs(rng, 40, 5)
    perm = rng.permutation(40)
    n_words = (total + 31) // 32
    np.testing.assert_array_equal(_k6(slab[perm], base[perm], n_words), _k6(slab, base, n_words))
    empty = _k6(np.zeros((0, 5), np.uint32), np.zeros(0, np.int32), 9)
    np.testing.assert_array_equal(empty, np.zeros(9, np.uint32))


# name -> part bit totals
STITCH_CASES = {
    "mixed": [37, 0, 64, 1, 500, 31, 32, 96, 1000, 3],
    "multiples-of-32-and-64": [32, 64, 128, 0, 64, 96, 32],
    "one-word-parts": [5, 17, 32, 1, 9, 31],
    "all-empty": [0, 0, 0],
    "first-empty": [0, 200, 0, 77],
    "one-part": [4099],
    "random": list(np.random.default_rng(11).integers(0, 3000, 12)),
}


def _parts(totals, seed):
    """(S, NW) u32 words with garbage past each part's total."""
    rng = np.random.default_rng(seed)
    nw = max(2, -(-max(totals) // 32) + 3)
    return rng.integers(0, 1 << 32, (len(totals), nw), dtype=np.uint64).astype(np.uint32)


j_stitch_words_device = jax.jit(jstitch.stitch_words_device, static_argnums=(2,))


@pytest.mark.parametrize("name", list(STITCH_CASES))
def test_stitch_words_device_matches_qb3_tpu(name):
    """The port's device stitch (K6's twin on the CPU) against qb3_tpu's
    stitch_words_device, jitted, and the host stitch_words; parts given as
    rows of one tensor and as a list of tensors trimmed to their totals
    (parts of one to five slabs)."""
    totals = [int(t) for t in STITCH_CASES[name]]
    words = _parts(totals, seed=len(name))
    total = sum(totals)
    n64 = total // 64 + 2
    want, jtotal = j_stitch_words_device(jnp.asarray(words), jnp.asarray(totals), n64)
    want = np.asarray(want)
    host, htotal = stitch.stitch_words([(w, n) for w, n in zip(words, totals)])
    assert total == int(jtotal) == htotal
    np.testing.assert_array_equal(want, host[:n64])
    w32 = torch.from_numpy(words.view(np.int32))
    trimmed = [w32[s, : -(-n // 32)].clone() for s, n in enumerate(totals)]
    for parts in (w32, trimmed):
        got, gtotal = stitch.stitch_words_device(parts, totals, 2 * n64)
        assert gtotal == total and got.dtype == torch.int32 and got.shape == (2 * n64,)
        np.testing.assert_array_equal(got.numpy().view(np.uint64), want)
    # the strip encoder's size: ceil(total / 32) words keep every bit
    got, _ = stitch.stitch_words_device(trimmed, totals, -(-total // 32))
    np.testing.assert_array_equal(got.numpy(), want.view(np.int32)[: -(-total // 32)])


@pytest.mark.parametrize("name", list(STITCH_CASES))
def test_host_stitch_copies_match_qb3_tpu(name):
    """stitch_words, stitch_bytes and assemble_scatter: the port's NumPy
    copies return qb3_tpu's words, totals and bytes."""
    totals = [int(t) for t in STITCH_CASES[name]]
    words = _parts(totals, seed=7 + len(name))
    parts = list(zip(words, totals))
    got, gtotal = stitch.stitch_words(parts)
    want, wtotal = jstitch.stitch_words(parts)
    np.testing.assert_array_equal(got, want)
    assert gtotal == wtotal
    assert stitch.stitch_bytes(parts) == jstitch.stitch_bytes(parts)
    rng = np.random.default_rng(len(name))
    owns = rng.integers(0, 1 << 63, (len(totals), 8), dtype=np.uint64)
    t = np.asarray(totals, np.int64)
    # each shard's words fit the output: base + n_own + 1 <= total // 64 + 2
    room = t.sum() // 64 + 1 - (np.cumsum(t) - t) // 64
    n_owns = np.minimum(rng.integers(0, 8, len(totals)), room)
    assert stitch.assemble_scatter(owns, n_owns, t) == jstitch.assemble_scatter(owns, n_owns, t)
