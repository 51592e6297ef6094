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
from qb3_tpu_torch.ops.place_cuda import place_slabs, place_slabs_plain

from .stitch_cases import STITCH_CASES, stitch_parts

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


j_stitch_words_device = jax.jit(jstitch.stitch_words_device, static_argnums=(2,))


@pytest.mark.parametrize("name", list(STITCH_CASES))
def test_stitch_words_device_matches_qb3_tpu(name):
    """The port's device stitch (K6's twin on the CPU) against qb3_tpu's
    stitch_words_device, jitted, and the host stitch_words; parts given as
    rows of one tensor and as a list of tensors trimmed to their totals
    (parts of one to five slabs)."""
    totals = [int(t) for t in STITCH_CASES[name]]
    words = stitch_parts(totals, seed=len(name))
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
    words = stitch_parts(totals, seed=7 + len(name))
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


# ------------------------------------------- the index rule of K6's pass
#
# A NumPy model of csrc/place.cu's output-major pass, step for step: a warp
# of 32 lanes owns WARP_WORDS consecutive output words and finds the first
# run that touches them (warp_search, 32 probes a round); lane l places the
# PER words at PER * l of each 32 * PER-word round, walking its run range
# forward from round to round, and combines the contributions of the runs
# that touch its words; a word no run touches is 0.  The kernel runs only on
# the card; the model shows here that its arithmetic is right.

WARP_WORDS, PER = 512, 4  # csrc/place.cu: kWarpWords, kPer


def _warp_search(pred, lo, hi):
    """csrc/place.cu's warp_search: the first r in [lo, hi) where pred(r), or
    hi; each round, lane j probes lo + j * step."""
    while hi - lo > 32:
        step = (hi - lo + 31) // 32
        t = [p >= hi or pred(p) for p in (lo + j * step for j in range(32))]
        if not any(t):
            lo += 31 * step + 1
        else:
            f = t.index(True)
            pf = lo + f * step
            if f > 0:
                lo += (f - 1) * step + 1
            hi = min(hi, pf)
    t = [lo + j >= hi or pred(lo + j) for j in range(32)]
    return lo + t.index(True) if any(t) else hi


def _funnelshift_l(lo: int, hi: int, sh: int) -> int:
    """CUDA's __funnelshift_l: the high word of (hi:lo) << (sh & 31)."""
    return ((((hi << 32) | lo) << (sh & 31)) >> 32) & M32


def _stitch_model(words, totals, n_out: int, warp_words: int = WARP_WORDS):
    """place_parts_kernel on (S, NW) u32 parts, over stitch.stitch_runs ->
    (n_out,) u32."""
    part, wb, end, nw, sh, mask = (r.tolist() for r in stitch.stitch_runs(totals))
    n = len(wb)

    def place(r, i0, w):  # PartRuns::place: ORs run r's words into w
        src = words[part[r]]
        k0 = i0 - wb[r]
        v = []
        for j in range(PER + 1):
            k = k0 - 1 + j
            x = int(src[k]) if 0 <= k < nw[r] else 0
            v.append(x & mask[r] if k == nw[r] - 1 else x)
        for c in range(PER):
            if wb[r] <= i0 + c < end[r]:
                w[c] |= _funnelshift_l(v[c], v[c + 1], sh[r])

    out = np.zeros(n_out, np.uint32)
    for wbase in range(0, n_out, warp_words):
        first = _warp_search(lambda q: end[q] > wbase, 0, n)
        for lane in range(32):
            lo = hi = first
            for i0 in range(wbase + PER * lane, min(wbase + warp_words, n_out), 32 * PER):
                while lo < n and end[lo] <= i0:
                    lo += 1
                hi = max(hi, lo)
                while hi < n and wb[hi] < i0 + PER:
                    hi += 1
                w = [0] * PER
                for r in range(lo, hi):
                    place(r, i0, w)
                m = min(PER, n_out - i0)
                out[i0:i0 + m] = w[:m]
    return out


@pytest.mark.parametrize("name", list(STITCH_CASES))
def test_stitch_runs_table(name):
    """stitch_runs: one column a part with bits, its word base, end word,
    source words, shift and last-word mask from its bit offset and total;
    bases and ends non-decreasing."""
    totals = [int(t) for t in STITCH_CASES[name]]
    runs = stitch.stitch_runs(totals)
    assert runs.dtype == np.int64 and runs.shape == (6, sum(t > 0 for t in totals))
    off = np.cumsum(totals) - totals
    for (s, wb, end, nw, sh, mask) in runs.T.tolist():
        o, n = int(off[s]), totals[s]
        assert n > 0 and (wb, sh) == (o // 32, o % 32)
        assert end == -(-(o + n) // 32) and nw == -(-n // 32)
        assert mask == (1 << (n % 32 or 32)) - 1
    assert (np.diff(runs[1]) >= 0).all() and (np.diff(runs[2]) >= 0).all()


@pytest.mark.parametrize("warp_words", [WARP_WORDS, 32 * PER])
@pytest.mark.parametrize("name", list(STITCH_CASES))
def test_k6_stitch_model_matches_qb3_tpu(name, warp_words):
    """The model of K6's stitch entry against the host stitch_words and
    qb3_tpu's jitted stitch_words_device, at ceil(total / 32) words; warps
    of one round (32 * PER words) put more warp edges inside parts."""
    totals = [int(t) for t in STITCH_CASES[name]]
    words = stitch_parts(totals, seed=len(name))
    total = sum(totals)
    n_out = -(-total // 32)
    host, htotal = stitch.stitch_words([(w, n) for w, n in zip(words, totals)])
    n64 = total // 64 + 2
    want, jtotal = j_stitch_words_device(jnp.asarray(words), jnp.asarray(totals), n64)
    assert total == htotal == int(jtotal)
    np.testing.assert_array_equal(np.asarray(want), host[:n64])
    got = _stitch_model(words, totals, n_out, warp_words)
    np.testing.assert_array_equal(got, host.view(np.uint32)[:n_out])


@pytest.mark.parametrize("name", ["mixed", "tiny-parts", "empty-first-and-last", "random"])
@pytest.mark.parametrize("extra", [-3, -1, 1, 50])
def test_k6_stitch_model_n_out(name, extra):
    """n_out short of the total drops the words past it; past the total the
    words are zero; equal to the port's stitch on the CPU (K6's twin)."""
    totals = [int(t) for t in STITCH_CASES[name]]
    words = stitch_parts(totals, seed=len(name))
    n_out = max(0, -(-sum(totals) // 32) + extra)
    host, _ = stitch.stitch_words([(w, n) for w, n in zip(words, totals)])
    want = np.zeros(n_out, np.uint32)
    m = min(n_out, host.size * 2)
    want[:m] = host.view(np.uint32)[:m]
    for warp_words in (WARP_WORDS, 32 * PER):
        np.testing.assert_array_equal(_stitch_model(words, totals, n_out, warp_words), want)
    twin, _ = stitch.stitch_words_device(torch.from_numpy(words.view(np.int32)), totals, n_out)
    np.testing.assert_array_equal(twin.numpy().view(np.uint32), want)


@pytest.mark.parametrize("n", [0, 1, 31, 32, 33, 1000, 212334])
def test_k6_warp_search_model(n):
    """The model of warp_search against np.searchsorted on non-decreasing
    keys with repeats, at every threshold's edge."""
    rng = np.random.default_rng(n)
    keys = np.sort(rng.integers(0, max(1, n // 3), n))
    for t in sorted(set(rng.integers(-1, max(2, n // 3) + 1, 40).tolist()) | {-1, 0}):
        want = int(np.searchsorted(keys, t, side="left"))
        assert _warp_search(lambda q: keys[q] >= t, 0, n) == want
        lo = int(rng.integers(0, want + 1))
        assert _warp_search(lambda q: keys[q] >= t, lo, n) == want


def test_k6_entries_on_cpu():
    """On CPU tensors place_slabs takes its twin (no launch), and the
    stitch entry, which runs only on the card, raises rather than fall
    back."""
    from qb3_tpu_torch.ops.place_cuda import place_parts

    slab, base, total = _slabs(np.random.default_rng(5), 50, 6)
    n_words = (total + 31) // 32
    before = place_slabs.launches, place_parts.launches
    got = place_slabs(torch.from_numpy(slab.view(np.int32)), torch.from_numpy(base), n_words)
    assert (place_slabs.launches, place_parts.launches) == before
    np.testing.assert_array_equal(got.numpy().view(np.uint32), _k6(slab, base, n_words))
    totals = [int(t) for t in STITCH_CASES["mixed"]]
    words = torch.from_numpy(stitch_parts(totals, 1).view(np.int32))
    with pytest.raises(ValueError, match="CUDA"):
        place_parts(words, stitch.stitch_runs(totals), -(-sum(totals) // 32))
