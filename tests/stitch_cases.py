"""Stitch inputs shared by the CPU tests (tests/test_torch_stitch.py) and the
card tests (tests/test_torch_cuda.py), made with numpy from a seed.

A device stitch places each part's bits at the sum of the earlier parts'
totals.  What can break it: parts of whole words (a shift of 0) and of 32
and 64 bits, empty parts first, last and between, parts under 32 bits that
put many parts on one output word, one part alone, every part empty, and
bits past each part's total that must not reach the stream.
"""

import numpy as np

# name -> part bit totals
STITCH_CASES = {
    "mixed": [37, 0, 64, 1, 500, 31, 32, 96, 1000, 3],
    "multiples-of-32-and-64": [32, 64, 128, 0, 64, 96, 32],
    "one-word-parts": [5, 17, 32, 1, 9, 31],
    "all-empty": [0, 0, 0],
    "first-empty": [0, 200, 0, 77],
    "one-part": [4099],
    "random": list(np.random.default_rng(11).integers(0, 3000, 12)),
    # up to 32 parts end on one output word
    "tiny-parts": [1] * 40 + list(np.random.default_rng(12).integers(0, 12, 60)) + [33],
    "empty-first-and-last": [0, 0, 45, 300, 0, 12, 0],
}


def stitch_parts(totals, seed):
    """(S, NW) u32 words, NW at least each part's words plus 3, with garbage
    past each part's total."""
    rng = np.random.default_rng(seed)
    nw = max(2, -(-max(totals) // 32) + 3)
    return rng.integers(0, 1 << 32, (len(totals), nw), dtype=np.uint64).astype(np.uint32)
