"""Edge inputs of the group pack (K1) and the fused VLC + pack (K8), made
with numpy from a seed.

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
"""

import numpy as np

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
