"""Edge inputs of K5a / K5b (the walks on gathered windows), made with
numpy from a seed.

A K5 block stages its groups' window rows (ngroups x nreg words, one
contiguous span) in shared memory, walks each group from its row and
stores its 16 values through shared memory.  So the inputs that can break
it are: every bit phase `off` in [0, 64); the widest codes of each type,
u64's rung-63 65-bit form with its 65th bit in the third word of the
value's window and past NREG; codes that run past NREG (read as zero);
ngroups that leave the last block partial, grids large enough for a block
to walk several rounds with the last ones partial or empty, and rows that
are not 16-byte aligned (nreg 1 or 5); nreg below the walk's window (_NREG_IX), as the
"ix" decode narrows it, and nreg 1; CF and CF0 groups with and without a
cf; IDX groups whose index codes reach every max index 0-7 (rung-2 codes
stop at 7); and kind codes outside 0-5, which decode as zero.

Each case is a stream in which group g's window is its own region of
REGION words, the nreg window words followed by zeros, so qb3_tpu's group
decode, reading the stream from the group's start bit, sees exactly the
bits K5 sees in the window.  The CPU tests hold the twins to qb3_tpu on
these inputs (the XLA group decode on every kind, the Pallas kernels in
interpret mode on kinds 0-2); the card tests hold the kernels to the twins.
"""

import numpy as np

from qb3_tpu_torch.offsets import (KIND_BITS, KIND_CF, KIND_CF0, KIND_IDX, KIND_NORMAL,
                                   KIND_ZERO)
from qb3_tpu_torch.ops.decode import K5_KIND

REGION = 48  # stream words a group: the longest window (36) and slack for the readers
ALL_KINDS = (KIND_NORMAL, KIND_ZERO, KIND_BITS, KIND_CF, KIND_CF0, KIND_IDX, 6, 7)
FAST_KINDS = (KIND_NORMAL, KIND_ZERO, KIND_BITS, KIND_CF, KIND_CF0)

# name -> (tbits, ngroups, nreg, walk kinds drawn, rung ("domain" or "top"),
#          cf given, off range)
CASES = {
    "u8-phases-all-kinds": (8, 129, 8, ALL_KINDS, "domain", True, 64),
    "u16-phases-all-kinds": (16, 127, 12, ALL_KINDS, "domain", False, 64),
    "u32-phases-all-kinds": (32, 129, 20, ALL_KINDS, "domain", True, 64),
    "u64-phases-all-kinds": (64, 143, 36, ALL_KINDS, "domain", False, 64),
    "u8-top-rung-1-group": (8, 1, 8, (KIND_NORMAL,), "top", False, 64),
    "u16-top-rung": (16, 129, 12, (KIND_NORMAL, KIND_CF), "top", True, 64),
    "u32-top-rung": (32, 127, 20, (KIND_NORMAL, KIND_CF), "top", True, 64),
    "u64-rung63-past-nreg-2": (64, 33, 2, (KIND_NORMAL,), "top", False, 32),
    "u64-rung63-nreg-3": (64, 129, 3, (KIND_NORMAL,), "top", False, 32),
    "u64-rung63-nreg-36": (64, 127, 36, (KIND_NORMAL, KIND_CF), "top", True, 64),
    "u8-nreg-1": (8, 129, 1, ALL_KINDS, "domain", True, 64),
    "u16-nreg-4": (16, 143, 4, ALL_KINDS, "domain", True, 64),
    "u32-nreg-5": (32, 129, 5, ALL_KINDS, "domain", False, 64),
    "u64-nreg-12": (64, 127, 12, ALL_KINDS, "domain", True, 64),
    "u8-idx-max-0-7": (8, 129, 8, (KIND_IDX,), "domain", False, 64),
    "u16-idx-max-0-7": (16, 127, 12, (KIND_IDX,), "top", False, 64),
    "u64-idx-max-0-7": (64, 129, 36, (KIND_IDX,), "top", False, 64),
    "u8-kinds-outside-0-5": (8, 127, 8, (6, 7), "domain", True, 64),
    "u64-kinds-outside-0-5": (64, 129, 36, (6, 7), "domain", True, 64),
    # grids of more than 2112 blocks of 128 groups: a block walks several
    # rounds, and the last block's last rounds are partial or empty
    "u8-rounds": (8, 2112 * 128 + 207, 8, FAST_KINDS, "domain", True, 64),
    "u64-rounds": (64, 2112 * 128 + 33, 36, FAST_KINDS, "domain", False, 64),
}
# the CPU twins and qb3_tpu take minutes on these; the card tests run them
CARD_ONLY = {"u8-rounds", "u64-rounds"}
OUTSIDE = np.array([6, 7, 8, 255, -1, 1 << 20], np.int32)  # K5 kind codes outside 0-5


def _idx_code(v: int) -> tuple:
    """The rung-2 plain code of index v in 0..7 -> (bits, length)."""
    if v < 2:
        return v << 1, 2
    if v < 4:
        return 1 | (v & 1) << 2, 3
    return 3 | (v & 3) << 2, 4


def stream_case(name: str, seed: int = 0) -> dict:
    """-> dict(words uint32 (ngroups * REGION,), val_pos int64, meta_kind
    uint8 (the walk's kinds, offsets.KIND_*), vrung int32, cf uint64 (zeros
    where none is given), off int32, kind int32 (K5's codes), cf_given,
    tbits, nreg): group g's window is words[g * REGION:][:nreg], random,
    with IDX groups' index codes and the first value of every top-rung u64
    group (a long form: low bits 11) written at off; the rest of its region
    is zero."""
    tbits, ng, nreg, kinds, rungs, cf_given, offs = CASES[name]
    rng = np.random.default_rng(seed + len(name))
    meta_kind = rng.choice(np.array(kinds, np.uint8), ng)
    off = (np.arange(ng) % offs if ng > 1 else rng.integers(0, offs, ng)).astype(np.int32)
    grouped = (meta_kind == KIND_NORMAL) | (meta_kind == KIND_CF)
    if rungs == "top":
        vrung = np.full(ng, tbits - 1, np.int32)
    else:
        vrung = rng.integers(0, tbits, ng).astype(np.int32)
        vrung = np.where(grouped & (vrung == 0), 1, vrung).astype(np.int32)
    win = rng.integers(0, 1 << 32, (ng, nreg), dtype=np.uint64)
    written = (meta_kind == KIND_IDX) | (tbits == 64 and rungs == "top")
    for g in np.flatnonzero(written):
        bits = int(sum(int(w) << (32 * j) for j, w in enumerate(win[g])))
        at = int(off[g])
        if meta_kind[g] == KIND_IDX:
            top = g % 8  # the group's max index
            idx = rng.integers(0, top + 1, 16)
            idx[rng.integers(0, 16)] = top
            for v in idx:
                code, n = _idx_code(int(v))
                bits = bits & ~(((1 << n) - 1) << at) | code << at
                at += n
        else:  # u64 at the top rung
            bits |= 3 << at  # a long form: the 65th bit lies in the third word
        bits &= (1 << (32 * nreg)) - 1
        win[g] = [(bits >> (32 * j)) & 0xFFFFFFFF for j in range(nreg)]
    words = np.zeros((ng, REGION), np.uint32)
    words[:, :nreg] = win
    kind = K5_KIND[meta_kind].astype(np.int32)
    if kinds == (6, 7):
        kind = rng.choice(OUTSIDE, ng)
    cf = rng.integers(0, 1 << 64, ng, dtype=np.uint64) if cf_given else np.zeros(ng, np.uint64)
    return dict(words=words.reshape(-1), val_pos=np.arange(ng, dtype=np.int64) * REGION * 32
                + off, meta_kind=meta_kind, vrung=vrung, cf=cf, off=off, kind=kind,
                cf_given=cf_given, tbits=tbits, nreg=nreg)


def k5_case(name: str, seed: int = 0) -> tuple:
    """K5's arguments of a case as numpy arrays: (regs int32 (ngroups,
    nreg), off, rung, kind int32 (ngroups,), nreg, tbits, cf int64 u64 or
    None)."""
    c = stream_case(name, seed)
    nreg = c["nreg"]
    regs = c["words"].reshape(-1, REGION)[:, :nreg].view(np.int32).copy()
    cf = c["cf"].view(np.int64) if c["cf_given"] else None
    return regs, c["off"], c["vrung"], c["kind"], nreg, c["tbits"], cf
