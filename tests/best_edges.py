"""Best-mode test rasters, made with numpy from a seed: kinds_scene, whose
groups reach every kind of the best modes (NORMAL, ZERO, BITS, CF, CF0,
IDX), and the edge inputs of K10 (the best modes' phase A in one kernel).

K10 computes each group's three candidates from its 16 values and the
block before it, then the band's CF chain across the tile, so its edge
inputs are groups of chosen mag-sign values: all values equal; 1 to 8
distinct values with tied counts (the uniques' stable order by descending
count); 9 distinct values (no index encoding); common factors 2, 3 and
others at every rung of the divided group, each twice in a row (the same-CF
header after the different-CF one); factors at and above 2^16 (u32, u64);
the u64 magnitude 2^63 alone and beside other values; u64 groups at rung 63.

This file imports neither jax nor qb3_tpu.
"""

import numpy as np
import torch

from qb3_tpu_torch import api
from qb3_tpu_torch.api import default_cband
from qb3_tpu_torch.constants import HILBERT, ZCURVE
from qb3_tpu_torch.ops.decode import reconstruct

from .pack_edges import from_mags


def _mags(v: int) -> int:
    """Mag-sign of a signed delta (QB3common.h:127-130)."""
    return 2 * v if v >= 0 else -2 * v - 1


def _group(regime: str, rng, tbits: int, fbits: int) -> list:
    """The 16 mag-sign values of one group of a regime: each best-mode
    group kind (NORMAL, ZERO, BITS, CF, CF0, IDX) from its own recipe, the
    common factors below 2^fbits."""
    if regime == "zero":
        return [0] * 16
    if regime == "bits":
        v = rng.integers(0, 2, 16)
        v[rng.integers(16)] = 1
        return [int(x) for x in v]
    if regime == "cf":  # every delta a multiple of a factor, some factors repeat
        f = int(rng.choice([3, 5, 12, 3 << min(tbits // 2 - 2, fbits - 2)]))
        return [_mags(f * int(q)) for q in rng.integers(-4, 5, 16)]
    if regime == "cf0":  # deltas 0 or -f: divided by f, every value is 0 or -1
        f = int(rng.choice([6, 7, 1 << min(tbits - 3, fbits - 1)]))
        v = rng.integers(0, 2, 16)
        v[rng.integers(16)] = 1
        return [_mags(-f * int(q)) for q in v]
    if regime == "idx":  # few large values: the index trial wins
        vals = rng.integers(1 << (tbits - 3), 1 << (tbits - 1), 3, dtype=np.uint64)
        return [int(vals[i]) for i in rng.integers(0, 3, 16)]
    # normal: low rungs mostly (the raster must stay compressible), any rung
    # now and then
    r = int(rng.integers(2, tbits if rng.random() < 0.2 else 4))
    return [int(x) for x in rng.integers(0, 1 << 62, 16, dtype=np.int64) % (1 << r)]


def kinds_scene(h: int, w: int, c: int, dtype, seed: int, order: int = HILBERT,
                fbits: int = 64):
    """A 4-aligned raster whose best-mode stream in the scan order `order`
    holds every group kind: mag-sign groups chosen block by block and band
    by band from the regimes of _group, turned into the raster by the
    decoder's reconstruct (the inverse of the encoder's scan and deltas).  u64 rasters also hold
    the magnitude 2^63 (the mag-sign value 2^64 - 1), alone (a CF0 group of
    factor 2^63) and among other values."""
    rng = np.random.default_rng(seed)
    tbits = 8 * np.dtype(dtype).itemsize
    nblocks = (h // 4) * (w // 4)
    regimes = ["normal", "zero", "bits", "cf", "cf0", "idx", "cf", "idx"]
    g = np.array([[_group(regimes[(b * c + i) % len(regimes)], rng, tbits, fbits)
                   for i in range(c)] for b in range(nblocks)], dtype=np.uint64)
    if tbits == 64:
        top = np.uint64(2**64 - 1)
        if fbits == 64:
            g[1, 0] = np.where(rng.integers(0, 2, 16) == 1, top, 0)
            g[1, 0, 3] = top
        g[2, 0, 5] = top
    groups = torch.from_numpy(g.view(np.int64))
    img, _ = reconstruct(groups, torch.zeros(c, dtype=torch.int64), h, w, c, order,
                         tuple(default_cband(c)), tbits)
    return api.from_carrier(img, tbits // 8)


# K10 cases: name -> (dtype, bands, curve); the groups of _edge_groups laid
# out block by block and band by band, in rows of 4 blocks
K10_CASES = {
    "edges-u8": (np.uint8, 1, HILBERT),
    "edges-u16": (np.uint16, 3, ZCURVE),
    "edges-u32": (np.uint32, 2, HILBERT),
    "edges-u64": (np.uint64, 1, ZCURVE),
}


def _cf_group(f: int, qs) -> list:
    """The mag-sign values of the deltas f * q."""
    return [_mags(f * int(q)) for q in qs]


def _quotients(rng, r: int) -> list:
    """16 quotients whose mag-sign values reach rung r exactly and whose
    greatest common factor is 1: one at the top of rung r, one of -1 or 1
    (0 or -1 at rung 0), the others random below the top."""
    if r == 0:
        return [-1] + [int(x) for x in -rng.integers(0, 2, 15)]
    top = 1 << (r - 1)  # mag-sign of top and of -top - 1 ... -2 top lie in rung r
    qs = [top if rng.random() < 0.5 else -2 * top, 1 if r > 1 else -1]
    qs += [int(x) for x in rng.integers(-top, top, 14)]
    order = rng.permutation(16)
    return [qs[i] for i in order]


def _edge_groups(tbits: int, rng) -> list:
    """K10's edge groups for tbits-wide values, each 16 mag-sign values."""
    top = (1 << tbits) - 1
    half = 1 << (tbits - 1)  # the largest magnitude
    groups = []
    for r in (0, 1, 3, 4, 7, tbits - 2, tbits - 1):  # all 16 values equal
        groups.append([min((1 << r) | (r & 1), top)] * 16)
    hi = max(4, tbits - 2)
    for counts in ((16,), (8, 8), (5, 5, 3, 3), (4, 4, 4, 4), (6, 5, 5), (3, 3, 2, 2, 2, 2, 1, 1),
                   (2,) * 8, (1, 2, 1, 2, 3, 3, 2, 2)):
        vals = [int(v) for v in rng.integers(1 << hi, 1 << (hi + 1), len(counts),
                                             dtype=np.uint64)]
        seq = [vals[k] for k, n in enumerate(counts) for _ in range(n)]
        groups.append([seq[i] for i in rng.permutation(16)])
    nine = [int(v) for v in rng.integers(1 << hi, 1 << (hi + 1), 9, dtype=np.uint64)]
    groups.append([nine[i % 9] for i in range(16)])
    factors = [2, 3, 5, 6, 2 + int(rng.integers(0, 1 << (tbits // 2 - 1)))]
    if tbits >= 32:
        factors += [1 << 16, (1 << 16) + 1, (1 << 20) + 7, 1 << (tbits - 3)]
    for f in factors:
        for r in range(tbits):
            if f << r > half:  # the deltas, down to -f * 2^r, must fit the type
                break
            g = _cf_group(f, _quotients(rng, r))
            groups += [g, g]  # the same CF again: the same-CF header
    if tbits == 64:
        m63 = top  # the mag-sign value of the magnitude 2^63
        groups.append([m63] * 16)
        groups.append([m63 if i % 2 else 0 for i in range(16)])
        groups.append([m63, _mags(6), _mags(-10)] + [0] * 13)
        groups.append([m63, _mags(1 << 62)] + [0] * 14)
        for _ in range(4):  # rung 63: values past 2^63, some with bit 62 (the 65th bit)
            v = rng.integers(0, 1 << 64, 16, dtype=np.uint64, endpoint=False)
            v[rng.integers(16)] |= np.uint64(1 << 63)
            groups.append([int(x) for x in v])
    return groups


def k10_case(name: str, seed: int = 0):
    """The raster of a K10 case, its curve and core bands -> (img (H, W, C),
    order, cband)."""
    dtype, nb, order = K10_CASES[name]
    rng = np.random.default_rng(seed + len(name))
    tbits = 8 * np.dtype(dtype).itemsize
    groups = _edge_groups(tbits, rng)
    nblocks = -(-len(groups) // (4 * nb)) * 4
    m = np.zeros((nblocks * nb, 16), np.uint64)
    m[:len(groups)] = np.array(groups, dtype=np.uint64)
    img = from_mags(m.reshape(nblocks, nb, 16), nblocks, 16, order, dtype)
    return img, order, tuple(range(nb))
