"""Vectorized QB3 group encoding: phase A of the two-phase encoder.

PyTorch counterpart of qb3_tpu/ops/encode.py.  For all microblocks at once it
computes the exact code word and bit length of every emitted symbol; phase B
(bitpack.py and the K1 kernel) places them.  The serial state of the
reference loop (QB3encode.h:376-451) becomes tensor algebra: the per-band
previous-value chain is a lag-1 shift of the scan sequence, the rung chain a
lag-1 shift of the per-block rung tensor.

Values ride in int64 carriers (bitutils.py).  Every function takes optional
leading batch axes ahead of the per-image axes: the batch encoder writes out
the tile axis that the JAX package gets from vmap.

Symbols per block/band: 1 prefix (codeswitch [+ all-zero flag]) + 16 value
codes [+ 16 overflow bits for 64-bit data at rung 63].
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import B, B2, curve_offsets, ubits_for
from .bitutils import mags, srl, step_flip_index, table, topbit, wrap


def block_origins(size: int) -> np.ndarray:
    """Block origin coordinates along one axis: 0,4,... with the last block
    shifted up/left to fit (QB3encode.h:409-416)."""
    n = (size + B - 1) // B
    out = np.arange(n, dtype=np.int64) * B
    out[-1] = size - B
    return out


def gather_blocks(img, order: int, cband: tuple[int, ...], tbits: int):
    """(..., H, W, C) int64 image -> (..., nblocks, C, B2) band-decorrelated
    values.

    Blocks enumerate row-major over (block-row, block-col); values within a
    block follow the scan curve; band decorrelation subtracts the core band
    (QB3encode.h:423-430).
    """
    *lead, h, w, nb = img.shape
    offs = curve_offsets(order)
    if h % B == 0 and w % B == 0:
        # aligned: blocks tile the image; the curve is a lane permutation
        perm = table(tuple(dy * B + dx for dy, dx in offs), img.device)
        t = img.reshape(*lead, h // B, B, w // B, B, nb)
        n = len(lead)
        t = t.permute(*range(n), n, n + 2, n + 4, n + 1, n + 3)
        vals = t.reshape(*lead, -1, nb, B2)[..., perm]
    else:
        ys = block_origins(h)
        xs = block_origins(w)
        dy = np.array([o[0] for o in offs])
        dx = np.array([o[1] for o in offs])
        iy = ys[:, None, None] + dy[None, None, :]  # (nby, 1, B2)
        ix = xs[None, :, None] + dx[None, None, :]  # (1, nbx, B2)
        flat = torch.as_tensor((iy * w + ix).reshape(-1), device=img.device)
        vals = img.reshape(*lead, h * w, nb)[..., flat, :]
        vals = vals.reshape(*lead, -1, B2, nb).transpose(-1, -2)
    core = vals[..., table(tuple(int(c) for c in cband), img.device), :]
    dep = table(tuple(int(c != i) for i, c in enumerate(cband)), img.device)
    return wrap(vals - core * dep[:, None], tbits)


def delta_mags(vals, entry_prev, tbits: int, lanewise=None):
    """Running per-band delta in scan order, then mag-sign transform.

    vals: (..., nblocks, C, B2); entry_prev: (..., C) persisted band state
    (QB3common.h:63-65).  Returns (mags, exit_prev).

    The two byte-identical formulations of the JAX package: ``lanewise``
    takes lane i's predecessor from lane i-1 of the same block (lane 0's from
    lane B2-1 of the previous block); otherwise the values go through the
    (C, nblocks*B2) sequence layout.  Default: lanewise for tbits > 8.
    """
    if lanewise is None:
        lanewise = tbits > 8
    if lanewise:
        last = vals[..., B2 - 1]  # (..., nblocks, C)
        prev_block = torch.cat([entry_prev[..., None, :], last[..., :-1, :]], dim=-2)
        prev = torch.cat([prev_block[..., None], vals[..., :-1]], dim=-1)
        return mags(wrap(vals - prev, tbits), tbits), last[..., -1, :]
    *lead, nblocks, nb, _ = vals.shape
    seq = vals.transpose(-3, -2).reshape(*lead, nb, nblocks * B2)
    prev = torch.cat([entry_prev[..., None], seq[..., :-1]], dim=-1)
    m = mags(wrap(seq - prev, tbits), tbits)
    return m.reshape(*lead, nb, nblocks, B2).transpose(-3, -2), seq[..., -1]


def block_rungs(m, entry_runbits):
    """Per-block bitsused/rung and the lag-1 rung chain (QB3encode.h:439-441).

    Returns (bitsused (..., nblocks, C), rung (..., nblocks, C) int64,
    oldrung, exit_runbits (..., C)).
    """
    bitsused = m[..., 0]
    for i in range(1, B2):
        bitsused = bitsused | m[..., i]
    rung = topbit(bitsused | 1)
    oldrung = torch.cat([entry_runbits[..., None, :].to(torch.int64), rung[..., :-1, :]],
                        dim=-2)
    return bitsused, rung, oldrung, rung[..., -1, :]


def value_codes_arith(m, rung, skipstep: bool, tbits: int):
    """Arithmetic group value codes: the base VLC (QB3encode.h:132-141)
    composed with the group-context value swap (rung 1: 1<->2, rung 2: 3<->4,
    rungs 3..7: 2^r-1 <-> 2^r).  Returns (codes, lens, ebits, elens) where
    (ebits, elens) carry the 65th bit of the rung-63 long code."""
    if not skipstep:
        match, ones = step_flip_index(m, rung)
        flip_ok = match & (ones > 0)
        lane = torch.arange(B2, device=m.device)
        do_flip = flip_ok[..., None] & (lane == (ones - 1)[..., None]) & (rung[..., None] >= 1)
        m = m ^ (do_flip.to(torch.int64) << rung[..., None])

    v = m
    rung_b = rung[..., None]  # broadcast over lanes

    # group-context value swap (rungs 1..7 only)
    a = torch.where(rung_b == 1, 1, torch.where(rung_b == 2, 3,
                    (1 << rung_b.clamp(0, 7)) - 1))
    do_swap = (rung_b >= 1) & (rung_b <= 7)
    v = torch.where(do_swap & (v == a), a + 1,
                    torch.where(do_swap & (v == a + 1), a, v))

    # base VLC (works for rung >= 1; rung-0 groups take the prefix path)
    r = rung_b.clamp(min=1)
    nxt = (v >> (r - 1)) & 1
    top = srl(v, r)
    tb = 1 << r
    lens = r + top + (top | nxt)
    codes = torch.where(top == 1, ((v ^ tb) << 2) | 3,
                        torch.where(nxt == 1, (((v << 1) ^ tb) << 1) | 1, v << 1))

    if tbits == 64:
        ovf = lens == 65
        ebits = torch.where(ovf, (v >> 62) & 1, 0)
        elens = ovf.to(torch.int64)
        lens = lens - elens
    else:
        ebits = torch.zeros_like(lens)
        elens = torch.zeros_like(lens)
    return codes, lens, ebits, elens


def csw_arith(rung, oldrung, ubits: int):
    """Arithmetic codeswitch code (tables.CSW equivalent): delta 0 is one
    0 bit, otherwise flag + base VLC of the biased mag-sign delta at rung
    ubits-1."""
    mask = (1 << ubits) - 1
    sb = 1 << (ubits - 1)
    d = (rung - oldrung) & mask
    msv = torch.where((d & sb) != 0, 2 * ((1 << ubits) - d) - 1, 2 * ((d - 1) & (sb - 1)))
    r = ubits - 1  # static, >= 2
    nxt = (msv >> (r - 1)) & 1
    top = msv >> r
    tb = 1 << r
    ln = r + top + (top | nxt) + 1
    code = torch.where(top == 1, ((msv ^ tb) << 2) | 3,
                       torch.where(nxt == 1, (((msv << 1) ^ tb) << 1) | 1, msv << 1))
    code = (code << 1) | 1
    return torch.where(d == 0, 0, code), torch.where(d == 0, 1, ln)


def fast_symbols(m, bitsused, rung, oldrung, ubits: int, skipstep: bool, tbits: int):
    """Symbols for the fast encoder (FTL / BASE): per block/band
    [prefix, v0..v15 (, e0..e15)] codes and lengths, shape (..., C, nsym)
    in stream order."""
    cs_code, cs_len = csw_arith(rung, oldrung, ubits)

    # all-zero or single-bit group (QB3encode.h:159-165); an unsigned
    # compare, as 64-bit patterns may be negative in the int64 carrier
    rung0 = (bitsused & ~1) == 0
    flag = bitsused & 1
    prefix_code = torch.where(rung0, cs_code | (flag << cs_len), cs_code)
    prefix_len = torch.where(rung0, cs_len + 1, cs_len)

    codes, lens, ebits, elens = value_codes_arith(m, rung, skipstep, tbits)
    # rung-0 class: each value is a single bit when bitsused==1, nothing if 0
    r0 = rung0[..., None]
    bit1 = (bitsused == 1)[..., None]
    codes = torch.where(r0, m & 1, codes)
    lens = torch.where(r0, bit1.to(torch.int64), lens)
    elens = torch.where(r0, 0, elens)

    if tbits == 64:
        # interleave value codes and their 65th bits: v0,e0,v1,e1,...
        codes = torch.stack([codes, ebits], dim=-1).flatten(-2)
        lens = torch.stack([lens, elens], dim=-1).flatten(-2)
    return (torch.cat([prefix_code[..., None], codes], dim=-1),
            torch.cat([prefix_len[..., None], lens], dim=-1))


def encode_fast_blocks(img, entry_prev, entry_runbits, order: int,
                       cband: tuple[int, ...], skipstep: bool, tbits: int,
                       with_rungs: bool = False, lanewise=None):
    """Full phase A for the fast encoder.

    img: (..., H, W, C) int64 carrier of tbits-wide unsigned values;
    entry_prev/entry_runbits: (..., C).  Returns (codes int64, lens int32,
    exit_prev, exit_runbits) with codes/lens shaped (..., ngroups, nsym) in
    stream order; with_rungs=True appends the per-block rung tensor
    (..., nblocks, C), the running runbits state the "ic" sidecar needs.
    """
    ubits = ubits_for(tbits // 8)
    vals = gather_blocks(img, order, cband, tbits)
    m, exit_prev = delta_mags(vals, entry_prev, tbits, lanewise)
    bitsused, rung, oldrung, exit_runbits = block_rungs(m, entry_runbits)
    codes, lens = fast_symbols(m, bitsused, rung, oldrung, ubits, skipstep, tbits)
    *lead, nblocks, nb, nsym = codes.shape
    out = (codes.reshape(*lead, nblocks * nb, nsym),
           lens.reshape(*lead, nblocks * nb, nsym).to(torch.int32),
           exit_prev, exit_runbits)
    if with_rungs:
        out = out + (rung,)
    return out
