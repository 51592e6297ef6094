"""Image-layout phase A for the fast encoder (wide types).

PyTorch counterpart of qb3_tpu/ops/encode_image.py.  Every phase-A quantity
is computed in image layout with elementwise ops and 4x4 window reductions;
the relayout of mag-sign values into curve order happens inside the K8
kernel (ops/encode_cuda.py), which reads them straight from the plane.

An (H, W, C) plane is handled as its block view (H/4, 4, W/4, 4, C), the
same memory with the in-block position on axes 1 and 3: per-position
tables are (1, 4, 1, 4, 1) tensors that broadcast over it, per-block values
(H/4, 1, W/4, 1, C), and block reductions run over axes (1, 3).  The JAX
module's full-size masks are compile-time constants; built eagerly they
would cost host time on every call.

Values ride in int64 carriers (bitutils.py), one plane per quantity: the
JAX package's (lo, hi) u32 pair planes work around XLA:TPU's slow u64
elementwise ops and have no counterpart here.

Key identities (reference: QB3encode.h:376-451):
  * the scan-order delta of value i is a fixed spatial shift that depends
    only on the pixel's position within its 4x4 block, plus one fixup for
    the block-row wrap;
  * the per-block "bits used" is the OR of the block's 16 values, taken as
    16 strided slices (a signed max of the carriers is wrong for patterns
    at or above 2^63);
  * the step detector (QB3common.h:141-166) is per-pixel
    `rung_bit == (curve_index < ones)` AND-reduced over the block, with
    `ones` a 4x4 window sum.

One departure from the JAX module: :func:`value_lens_planes` measures each
code after the group-context swap of rungs 1..7, as the codes are emitted;
qb3_tpu's measures the value before it (ROADMAP.md Queue 3).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..constants import B, B2, curve_offsets, ubits_for
from .bitutils import mags, srl, topbit, wrap
from .encode import csw_arith


def _lane_tables(order: int):
    offs = curve_offsets(order)
    lane_of = np.zeros((B, B), dtype=np.int64)
    for i, (dy, dx) in enumerate(offs):
        lane_of[dy, dx] = i
    return offs, lane_of


@functools.lru_cache(maxsize=None)
def _position_tables(order: int, device: torch.device):
    """Per-position tables of a curve on `device`, (1, 4, 1, 4, 1) each:
    the curve index of every in-block position, and for each spatial shift
    (ddy, ddx) the positions whose scan predecessor lies at that shift."""
    offs, lane_of = _lane_tables(order)
    pred = {}
    for i in range(1, B2):
        d = (offs[i - 1][0] - offs[i][0], offs[i - 1][1] - offs[i][1])
        pred.setdefault(d, []).append(offs[i])
    (dy0, dx0), (dy15, dx15) = offs[0], offs[B2 - 1]
    pred.setdefault((dy15 - dy0, dx15 - dx0 - B), []).append(offs[0])
    shifts = []
    for d, pixels in pred.items():
        mask = np.zeros((B, B), dtype=bool)
        for py, px in pixels:
            mask[py, px] = True
        shifts.append((d, torch.as_tensor(mask, device=device).view(1, B, 1, B, 1)))
    ci = torch.as_tensor(lane_of, device=device).view(1, B, 1, B, 1)
    return ci, shifts


def _blocks(x):
    """(H, W, C) -> its block view (H/4, 4, W/4, 4, C)."""
    h, w, nb = x.shape
    return x.view(h // B, B, w // B, B, nb)


def _per_block(x):
    """(nby, nbx, C) per-block values -> (nby, 1, nbx, 1, C), to broadcast
    over a block view."""
    return x[:, None, :, None, :]


def _block_or(x5):
    """OR over each block of a block view -> (nby, nbx, C), as 16 strided
    slices, one per in-block position."""
    out = x5[:, 0, :, 0]
    for i in range(1, B2):
        out = out | x5[:, i // B, :, i % B]
    return out


def decorrelate_planes(img, cband: tuple[int, ...], tbits: int):
    """Band decorrelation (QB3encode.h:423-430): subtract the core band."""
    nb = img.shape[2]
    cb = np.asarray(cband)
    sub = torch.as_tensor(cb != np.arange(nb), device=img.device)
    core = img[:, :, torch.as_tensor(cb, device=img.device)]
    return wrap(img - torch.where(sub, core, 0), tbits)


def delta_planes(v, entry_prev, order: int, tbits: int):
    """Scan-order running delta in image layout.

    v: (H, W, C) carrier; entry_prev: (C,).  Returns (d, exit_prev (C,))."""
    h, w, nb = v.shape
    offs = curve_offsets(order)
    (dy0, dx0), (dy15, dx15) = offs[0], offs[B2 - 1]
    _, shifts = _position_tables(order, v.device)
    p = torch.zeros_like(_blocks(v))
    for (ddy, ddx), mask in shifts:
        p = torch.where(mask, _blocks(torch.roll(v, (-ddy, -ddx), (0, 1))), p)
    # block-row wrap: predecessor of block (by, 0)'s first value is block
    # (by-1, nbx-1)'s last (entry_prev for by == 0)
    last = v[dy15::B, w - B + dx15, :]  # (nby, C)
    p[:, dy0, 0, dx0] = torch.cat([entry_prev[None, :].to(v.dtype), last[:-1]], 0)
    d = wrap(_blocks(v) - p, tbits).view(h, w, nb)
    return d, v[h - B + dy15, w - B + dx15, :]


def step_flip_planes(m, rung, order: int):
    """Encoder-side step flip in image layout (QB3encode.h:169-176).

    m: (H, W, C) mag-sign carrier; rung: (nblocks, C)."""
    h, w, nb = m.shape
    m5 = _blocks(m)
    ci, _ = _position_tables(order, m.device)
    r = _per_block(rung.view(h // B, w // B, nb))
    bit = srl(m5, r) & 1
    ones = bit.sum((1, 3), keepdim=True)
    match = (bit == (ci < ones).to(torch.int64)).sum((1, 3), keepdim=True) == B2
    do = match & (ones > 0) & (ci == ones - 1) & (r >= 1)
    return (m5 ^ (do.to(torch.int64) << r)).view(h, w, nb)


def value_lens_planes(m, rung, bu_r0, bu_bit1):
    """Per-value full code lengths (the u64 65th bit included), as the block
    view (nby, 4, nbx, 4, C); bu_r0 / bu_bit1 (nby, nbx, C).

    The length is that of the code emitted: the base VLC of the value after
    the group-context swap (rung 1: 1<->2, rung 2: 3<->4, rungs 3..7:
    2^r-1 <-> 2^r), which trades a nominal code for a long one."""
    h, w, nb = m.shape
    m5 = _blocks(m)
    r = _per_block(rung.view(h // B, w // B, nb)).clamp(min=1)
    a = torch.where(r == 1, 1, torch.where(r == 2, 3, (1 << r.clamp(max=7)) - 1))
    swap = r <= 7
    v = torch.where(swap & (m5 == a), a + 1, torch.where(swap & (m5 == a + 1), a, m5))
    # v < 2^(r+1): top = bit r, nxt = bit r-1
    top = srl(v, r) & 1
    nxt = srl(v, r - 1) & 1
    lens = r + top + (top | nxt)
    return torch.where(_per_block(bu_r0), _per_block(bu_bit1).to(torch.int64), lens)


def prefix_symbols(bu_le1, bu_eq1, rung, oldrung, ubits: int):
    """Codeswitch [+ all-zero flag] per group, (nblocks, C)."""
    cs_code, cs_len = csw_arith(rung, oldrung, ubits)
    code = torch.where(bu_le1, cs_code | (bu_eq1.to(torch.int64) << cs_len), cs_code)
    return code, torch.where(bu_le1, cs_len + 1, cs_len)


def phase_a_image(img, entry_prev, entry_runbits, order: int, cband: tuple[int, ...],
                  skipstep: bool, tbits: int):
    """Full image-layout phase A.

    img: (H, W, C) int64 carrier of tbits-wide unsigned values, H and W
    multiples of 4; entry_prev / entry_runbits: (C,).  Returns a dict with:
    m (H, W, C) int64 mag-sign plane (step-flipped for BASE), rung
    (nblocks, C) int64, gkind (0 normal / 1 bits / 2 zero), prefix_code /
    prefix_len (nblocks, C), glen (ngroups,) int64 in raster-block x band
    order, exit_prev (C,) in the carrier, exit_runbits (C,).
    """
    nb = img.shape[2]
    ubits = ubits_for(tbits // 8)
    v = decorrelate_planes(img, cband, tbits)
    d, exit_prev = delta_planes(v, entry_prev, order, tbits)
    m = mags(d, tbits)
    bor = _block_or(_blocks(m))  # (nby, nbx, C)
    rung3 = topbit(bor | 1)
    # unsigned compares: u64 patterns may be negative in the carrier
    bu_le1 = (bor & ~1) == 0
    bu_eq1 = bor == 1
    rung = rung3.reshape(-1, nb)
    bu_le1f = bu_le1.reshape(-1, nb)
    bu_eq1f = bu_eq1.reshape(-1, nb)
    oldrung = torch.cat([entry_runbits[None, :].to(torch.int64), rung[:-1]], 0)
    if not skipstep:
        m = step_flip_planes(m, rung, order)
    pcode, plen = prefix_symbols(bu_le1f, bu_eq1f, rung, oldrung, ubits)
    vlens = value_lens_planes(m, rung, bu_le1, bu_eq1)
    glen = (plen + vlens.sum((1, 3)).reshape(-1, nb)).reshape(-1)
    gkind = torch.where(~bu_le1f, 0, torch.where(bu_eq1f, 1, 2)).reshape(-1)
    return dict(m=m, rung=rung, gkind=gkind, prefix_code=pcode, prefix_len=plen,
                glen=glen, exit_prev=exit_prev, exit_runbits=rung[-1])
