"""Edge inputs of the group pack (K1), the fused VLC + pack (K8) and the
fast encoder's phase A (K9), made with numpy from a seed.

The kernels scan the group lengths in blocks of BLOCK groups (a decoupled
look-back across blocks, restarting at every tile) and assemble each
block's words in shared memory, so the inputs that can break them are: one
group, a group count that is not a multiple of BLOCK, many tiles, zero-length
groups (a whole block of them emits no bits), block edges at every bit
phase, totals past the stream buffer (truncation) and u64 codes of 65 bits;
at the fast modes' symbol counts (S = 17, 33 for u64) and the best modes'
(S = 27, 43 for u64: 3 prefix symbols, 16 values with their 65th bits for
u64, 8 index uniques), where a K1 block stages more shared memory.  The CPU
tests hand small versions to qb3_tpu's Pallas kernels in interpret mode and
to the port's twins; the card tests hand them to the kernels.

K9 computes each group's symbols from its 16 values and the block before
it, so its edge inputs are groups of chosen mag-sign values: all-zero
groups, bitsused == 1 (rung 0 with one bit a value), the step's 1*0*
patterns of every length at low and high rungs (and patterns that are not
1*0*), u64 groups at rung 63 whose long codes take a 65th bit, and values
at each type's maximum.
"""

import numpy as np

from qb3_tpu_torch.constants import HILBERT, ZCURVE, curve_offsets

BLOCK = 128  # groups a K1 block packs (qb3_tpu_torch.ops.pack_cuda.PACK_G)

# K1 cases: name -> (tiles, groups a tile, symbols a group, longest code)
K1_CASES = {
    "one-group": (1, 1, 17, 9),
    "ragged": (1, 300, 17, 17),
    "tiles": (300, 200, 17, 9),
    "zero-block": (1, 400, 17, 17),
    "phases": (32, 2 * BLOCK, 17, 9),
    "truncated": (1, 300, 17, 17),
    "u64-65-bit": (1, 300, 33, 64),
    "s27-one-group": (1, 1, 27, 17),
    "s27-ragged": (1, 300, 27, 17),
    "s27-truncated": (1, 300, 27, 17),
    "s43-one-group": (1, 1, 43, 64),
    "s43-ragged": (1, 300, 43, 64),
    "s43-truncated": (1, 300, 43, 64),
    "s43-65-bit": (1, 300, 43, 64),
}
# small versions for the CPU: the JAX kernel packs one tile a call
K1_SMALL = {"tiles": (3, 200, 17, 9), "phases": (4, 2 * BLOCK, 17, 9)}


def random_codes(rng, lens):
    """Random codes of the given lengths, nothing above a code's length."""
    bits = rng.integers(0, 1 << 64, lens.shape, dtype=np.uint64, endpoint=False)
    keep = np.where(lens >= 64, ~np.uint64(0),
                    (np.uint64(1) << np.minimum(lens, 63).astype(np.uint64)) - np.uint64(1))
    return bits & keep


def k1_case(name: str, small: bool = False, seed: int = 0):
    """-> (codes (tiles, groups, S) uint64, lens int32, n_words)."""
    ntiles, ngroups, S, maxlen = (K1_SMALL if small else {}).get(name, K1_CASES[name])
    rng = np.random.default_rng(seed + len(name))
    lens = rng.integers(0, maxlen + 1, (ntiles, ngroups, S)).astype(np.int32)
    lens[rng.random(lens.shape) < 0.2] = 0
    if name.endswith("65-bit"):
        # the prefix (one symbol, or the best modes' three), then each
        # value's 64-bit code and its 65th bit (then the best modes' uniques)
        p = 1 if S == 33 else 3
        lens[..., p:p + 32:2] = 64
        lens[..., p + 1:p + 32:2] = 1
        lens[..., :p] = rng.integers(1, 10, (ntiles, ngroups, p))
    if name == "zero-block":
        lens[:, BLOCK:2 * BLOCK] = 0  # a whole block emits no bits
    if name == "phases":
        # tile t's first block ends at bit phase t % 32 with a group of 32-63
        # bits across the word there
        lens[:, BLOCK - 1] = 0
        before = lens[:, :BLOCK - 1].astype(np.int64).sum((1, 2))
        lens[:, BLOCK - 1, 0] = 32 + (np.arange(ntiles) - before) % 32
    total = int(lens.astype(np.int64).sum((1, 2)).max())
    n_words = total // 64 if name.endswith("truncated") else total // 32 + 2
    return random_codes(rng, lens), lens, n_words


# K8 cases: name -> (dtype, H, W, C); the CPU's take the JAX kernel's shape
# rule (W / 4 * C) % 128 == 0
K8_CASES = {
    "one-group": (np.uint16, 4, 4, 1),
    "c1-zero-block-phases": (np.uint16, 4, 4 * BLOCK * 33, 1),
    "c3": (np.uint16, 12, 100, 3),
    "c8": (np.uint32, 8, 72, 8),
    "c13": (np.uint16, 8, 44, 13),
    "c200": (np.uint16, 4, 8, 200),
    "truncated": (np.uint16, 16, 1024, 1),
    "u64-65-bit": (np.uint64, 8, 48, 3),
}
K8_SMALL = {
    "c1-zero-block-phases": (np.uint16, 4, 4 * BLOCK * 3, 1),
    "c3": (np.uint16, 4, 512, 3),
    "c8": (np.uint32, 4, 64, 8),
    "truncated": (np.uint16, 4, 512, 1),
}  # 13 bands take W = 512 there, ~20 s in interpret mode: the card tests only


def k8_image(name: str, small: bool = False, seed: int = 0):
    """The raster of a K8 case: grain and edges, full-range noise for u64
    (rung 63, the 65-bit code)."""
    dtype, h, w, c = (K8_SMALL if small else {}).get(name, K8_CASES[name])
    rng = np.random.default_rng(seed + len(name))
    if dtype == np.uint64:
        return rng.integers(0, 1 << 64, (h, w, c), dtype=np.uint64, endpoint=False)
    bits = 8 * np.dtype(dtype).itemsize
    img = rng.integers(0, 1 << (bits // 2), (h, w, c)).astype(dtype)
    img[::5, ::7] = np.iinfo(dtype).max  # high rungs beside the grain's low ones
    return img


def k8_edit(name: str, gkind, pcode, plen, glen, seed: int = 0):
    """Edit phase A's per-group fields (numpy int64, in place) for a K8
    case: a whole block of zero-length groups (kind 2 with no prefix), and
    block edges at every bit phase (the last group of block k a kind-2 group
    of 32-63 prefix bits that ends at phase k % 32).  Blocks of BLOCK groups
    hold for one band (C = 1)."""
    if name != "c1-zero-block-phases":
        return
    rng = np.random.default_rng(seed)
    zero = slice(0, BLOCK)
    gkind[zero], pcode[zero], plen[zero], glen[zero] = 2, 0, 0, 0
    for k in range(1, gkind.shape[0] // BLOCK):
        last = (k + 1) * BLOCK - 1
        n = 32 + (k - int(glen[:last].sum())) % 32
        gkind[last], plen[last], glen[last] = 2, n, n
        pcode[last] = int(rng.integers(0, 1 << 32))  # the JAX kernel's prefix codes are u32


def k8_n_words(name: str, glen, n_words: int) -> int:
    """The stream buffer of a K8 case: half the bits for truncation."""
    return int(glen.sum()) // 64 if name == "truncated" else n_words


# K9 cases: name -> (dtype, H, W, C, curve); a case runs with the step
# skipped (FTL) and kept (BASE)
K9_CASES = {
    "zero-groups": (np.uint8, 32, 48, 2, HILBERT),
    "bitsused-1": (np.uint16, 32, 64, 1, HILBERT),
    "steps-u8": (np.uint8, 16, 4 * 7 * 18, 1, ZCURVE),
    "steps-u16": (np.uint16, 16, 4 * 15 * 18, 1, HILBERT),
    "steps-u64": (np.uint64, 8, 4 * 8 * 18, 1, HILBERT),
    "u64-rung-63": (np.uint64, 16, 64, 3, ZCURVE),
    "max-u8": (np.uint8, 20, 36, 3, HILBERT),
    "max-u16": (np.uint16, 20, 36, 4, ZCURVE),
    "max-u32": (np.uint32, 12, 20, 1, HILBERT),
    "max-u64": (np.uint64, 12, 20, 2, HILBERT),
}
K9_STEP_RUNGS = {"steps-u8": list(range(1, 8)), "steps-u16": list(range(1, 16)),
                 "steps-u64": [1, 7, 8, 31, 32, 33, 62, 63]}


def from_mags(m, h: int, w: int, order: int, dtype):
    """The (H, W, C) raster whose band-wise deltas in scan order, from a
    band state of 0, have the mag-sign values m (nblocks, C, 16) uint64:
    blocks in raster order, values in curve order.  H and W are multiples of
    4, and the bands are independent (cband = range(C))."""
    bits = 8 * np.dtype(dtype).itemsize
    m = np.asarray(m, np.uint64)
    d = (m >> np.uint64(1)) ^ (np.uint64(0) - (m & np.uint64(1)))  # mag-sign -> two's complement
    nblocks, nb, _ = m.shape
    seq = np.cumsum(d.transpose(1, 0, 2).reshape(nb, -1), axis=1, dtype=np.uint64)
    if bits < 64:
        seq &= np.uint64((1 << bits) - 1)
    vals = seq.reshape(nb, h // 4, w // 4, 4, 4)  # band, block-row, block-col, lane
    img = np.zeros((h, w, nb), np.uint64)
    for i, (dy, dx) in enumerate(curve_offsets(order)):
        img[dy::4, dx::4, :] = vals[..., i // 4, i % 4].transpose(1, 2, 0)
    return img.astype(dtype)


def k9_case(name: str, seed: int = 0):
    """The raster of a K9 case and its curve -> (img (H, W, C), order)."""
    dtype, h, w, nb, order = K9_CASES[name]
    rng = np.random.default_rng(seed + len(name))
    bits = 8 * np.dtype(dtype).itemsize
    nblocks = (h // 4) * (w // 4)
    u64 = np.uint64
    if name.startswith("max-"):
        top = np.iinfo(dtype).max
        pick = rng.integers(0, 4, (h, w, nb))
        img = np.choose(pick, [np.zeros((), dtype), np.full((), top, dtype),
                               np.full((), top - 1, dtype), np.full((), top >> 1, dtype)])
        img[: h // 2, : w // 2] = top  # whole groups at the maximum
        return img.astype(dtype), order
    if name == "zero-groups":
        m = np.zeros((nblocks, nb, 16), u64)
        live = rng.random((nblocks, nb)) < 0.15
        m[live] = rng.integers(0, 1 << 6, (int(live.sum()), 16)).astype(u64)
    elif name == "bitsused-1":
        m = (rng.random((nblocks, nb, 16)) < 0.3).astype(u64)
        m[::5] = 0
        m[1::7] = 1
    elif name.startswith("steps"):
        # group j: rung r, with bit r set in the first k values (the 1*0*
        # pattern of length k = 1..16), or at k = 0 in a random set of
        # values that is not of that form; bits below r random
        rungs = K9_STEP_RUNGS[name]
        m = np.zeros((nblocks, nb, 16), u64)
        lane = np.arange(16)
        for j in range(nblocks):
            r, k = rungs[j % len(rungs)], (j // len(rungs)) % 17
            low = rng.integers(0, 1 << min(r, 62), 16, dtype=np.int64).astype(u64)
            if r == 63:
                low |= rng.integers(0, 2, 16).astype(u64) << u64(62)
            top = lane < k if k else rng.random(16) < 0.5
            if not k:
                top[[3, 9]] = True, False  # a 1 after a 0: never 1*0*
                top[10] = True
            m[j, :, :] = low | (top.astype(u64) << u64(r))
    else:  # u64-rung-63: full-range values, bit 63 set in some of a group's
        m = rng.integers(0, 1 << 64, (nblocks, nb, 16), dtype=np.uint64, endpoint=False)
        m[::3, :, 5] |= u64(1) << u64(63)
        m[1::4] &= u64((1 << 63) - 1)
    return from_mags(m, h, w, order, dtype), order
