"""Value decoding primitives, the "ix" sidecar decode, the decode of groups
located by the serial walk, and image reconstruction.

PyTorch counterpart of qb3_tpu/ops/decode.py: the arithmetic codeswitch
and VLC decoders, the "ix" decode (decode_indexed_narrow: K4, or gathered
windows and K5, with the XLA walk's formulation as their twins' body), the
decode of the groups that the serial walk or an "ib" sidecar located, the
best modes' CF, CF0 and IDX groups included (decode_groups: K7 gathers the
windows, K5 walks them),
and the step from decoded mag-sign groups to the image — the per-band
prefix-sum un-delta
(QB3decode.h:717-722), the inverse scan, and the band-delta add pass
(QB3decode.h:729-737).  Values ride in int64 carriers (bitutils.py);
int64 sums wrap like uint64, so the un-delta needs none of the JAX
package's u32 plane splitting.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import B, B2, curve_offsets
from ..offsets import KIND_BITS, KIND_CF, KIND_CF0, KIND_IDX, KIND_NORMAL, KIND_ZERO
from .bitutils import (M32, peek64, smag, srl, step_flip_index, table, words_u32, words_u64,
                       wrap)
from .encode import block_origins


def payload_words(payload: bytes) -> np.ndarray:
    """Payload bytes -> little-endian uint64 words with a spill word."""
    n = (len(payload) + 7) // 8 + 1
    buf = np.zeros(n * 8, dtype=np.uint8)
    buf[: len(payload)] = np.frombuffer(payload, np.uint8)
    return buf.view("<u8")


def dsw_arith(w1, ubits: int):
    """Arithmetic codeswitch decode == the DSW table (tables._make_dsw).

    w1: int64 stream bits AFTER the change flag.  Returns (cs_len incl flag,
    delta), valid where the flag was 1.
    """
    r = ubits - 1  # plain VLC rung of the codeswitch code
    rbit = 1 << r
    vmask = rbit - 1
    short = (w1 & 1) == 0
    n = (w1 >> 1) & 1
    v2 = srl(w1, 2) & vmask
    v = torch.where(short, (w1 & vmask) >> 1,
                    torch.where(n == 0, v2 | (rbit >> 1), v2 | rbit))
    ln = torch.where(short, r, r + 1 + n) + 1
    mag = v >> 1
    neg = (v & 1) == 1
    delta = torch.where(neg, (-(mag + 1)) & ((1 << ubits) - 1),
                        (mag + 1) & ((1 << (ubits - 1)) - 1))
    return ln, delta


def _vlc_decode_arith(w, rung):
    """Arithmetic group-context VLC decode: base 3-range code + value swap.

    The decode tables are the inverse of (swap o vlc); the swap is an
    involution, so decode == swap(vlc_decode(bits)).  Valid for rung >= 1;
    the rung-0 class never reaches here.  w: int64 stream bits (the low
    rung+2 matter); returns (value, length).
    """
    r = rung.clamp(min=1)
    rbit = 1 << r
    vmask = rbit - 1
    short = (w & 1) == 0
    n = (w >> 1) & 1
    v2 = srl(w, 2) & vmask
    v = torch.where(short, srl(w & vmask, 1),
                    torch.where(n == 0, v2 | srl(rbit, 1), v2 | rbit))
    ln = torch.where(short, r, r + 1 + n)
    # group-context swap (rung 1: 1<->2, rung 2: 3<->4, 3..7: 2^r-1<->2^r)
    a = torch.where(r == 1, 1, torch.where(r == 2, 3, (1 << r.clamp(max=7)) - 1))
    do_swap = r <= 7
    v = torch.where(do_swap & (v == a), a + 1,
                    torch.where(do_swap & (v == a + 1), a, v))
    return v, ln


def _vlc_decode_plain(w, rung):
    """Base 3-range decode with no swap (index codes at rung 2, the IDX_DEC
    table) -> (value, length); rung 0 is taken as 1."""
    r = rung.clamp(min=1)
    rbit = 1 << r
    vmask = rbit - 1
    short = (w & 1) == 0
    n = (w >> 1) & 1
    v = torch.where(short, srl(w & vmask, 1),
                    srl(w, 2) & vmask | torch.where(n == 0, srl(rbit, 1), rbit))
    return v, torch.where(short, r, r + 1 + n)


def _vlc_decode_single(w, rung):
    """Single-value context decode (CF values, index uniques; the
    DEC_SINGLE table and its computed rungs): the plain decode with the
    rung 3..7 middle swap, rung 0 one literal bit -> (value, length)."""
    v, ln = _vlc_decode_plain(w, rung)
    a = (1 << rung.clamp(0, 7)) - 1
    do = (rung >= 3) & (rung <= 7)
    v = torch.where(do & (v == a), a + 1, torch.where(do & (v == a + 1), a, v))
    return torch.where(rung == 0, w & 1, v), torch.where(rung == 0, 1, ln)


def step_restore(g, rung, is_group):
    """BASE-mode step-bit restore (QB3decode.h:285-289) of (..., B2)
    mag-sign groups: flip bit `rung` of value #ones where the rung bits
    form the pattern 1*0*."""
    match, ones = step_flip_index(g, rung)
    do = is_group & match & (rung >= 1)
    lane = torch.arange(B2, device=g.device)
    flip = do[..., None] & (lane == ones[..., None]) & (ones[..., None] < B2)
    return g ^ (flip.to(torch.int64) << rung[..., None])


def window64(regs, o):
    """64 stream bits at bit o of each row's register window.

    regs: (n, NREG + 2) int64 u32 words, the last two zero; word indices
    outside [0, NREG - 1] read from word NREG - 1 on, as the JAX select
    chains' default."""
    nreg = regs.shape[1] - 2
    wi = o >> 5
    wi = torch.where((wi < 0) | (wi > nreg - 1), nreg - 1, wi)[:, None]
    sh = o & 31
    lo = (regs.gather(1, wi) | (regs.gather(1, wi + 1) << 32))[:, 0]
    w2 = regs.gather(1, wi + 2)[:, 0]
    return srl(lo, sh) | torch.where(sh == 0, 0, w2 << ((64 - sh) & 63))


# ------------------------------------------------- "ix" sidecar decode

# Window words per group: the longest group from any bit phase.  The walk
# decode (decode_groups) starts a window at the word of the first value bit,
# so up to 31 bits of phase come before the group's value bits, and every
# kind's value bits fit the longest NORMAL group's, 16 codes at the top
# rung r = tbits - 1 of r + 2 bits each (u64: rung 63's 65-bit form):
#   u8  NORMAL 16 * 9 = 144; CF (rung <= 6) 16 * 8 = 128; IDX 16 index
#       codes of <= 4 bits + 8 uniques of <= 9 = 136 -> 31 + 144 = 175 <= 256
#   u16 NORMAL 272; CF 256; IDX 64 + 8 * 17 = 200 -> 303 <= 12 * 32 = 384
#   u32 NORMAL 528; CF 512; IDX 64 + 8 * 33 = 328 -> 559 <= 20 * 32 = 640
#   u64 NORMAL 1040; CF (rung <= 62) 1024; IDX 64 + 8 * 65 = 584
#       -> 1071 <= 36 * 32 = 1152
# BITS and CF0 take 16 bits.  So a best-mode group never reads past its
# window, where K7 would give zeros and qb3_tpu the stream's bits; the "ix"
# decode sizes it down from its sidecar (api._indexed_nreg).
_NREG_IX = {8: 8, 16: 12, 32: 20, 64: 36}
_GMAX_IX = {8: 150, 16: 280, 32: 540, 64: 1056}  # longest group in bits

# K5's kind codes (0 all zero, 1 group-coded, 2 literal bits, 3 CF, 4 CF0,
# 5 IDX), indexed by the walk's kind (offsets.KIND_*; 6 and 7, which only a
# damaged "ib" sidecar gives, decode as zero, as in qb3_tpu): the one place
# where the two codes meet
K5_KIND = np.array([{KIND_NORMAL: 1, KIND_ZERO: 0, KIND_BITS: 2, KIND_CF: 3, KIND_CF0: 4,
                     KIND_IDX: 5}.get(k, 0) for k in range(8)], np.int32)


def indexed_meta(words64, glens, nblocks: int, nbands: int, ubits: int):
    """Per-group metadata from the "ix" sidecar, the input decode_groups
    takes: (kind uint8, val_pos, vrung, cf) flat int64 tensors.

    FTL/BASE streams have no extended encodings, so the rung chain is a
    modular prefix sum of codeswitch deltas, each read at its group's start
    bit.  glens: (nblocks * nbands,) per-group bit lengths."""
    words64 = words_u64(words64)
    glens = glens.to(torch.int64)
    goff = (torch.cumsum(glens, 0) - glens).reshape(nblocks, nbands)
    w = peek64(words64, goff)
    has_cs = (w & 1) == 1
    dlen, ddelta = dsw_arith(srl(w, 1), ubits)
    cs_len = torch.where(has_cs, dlen, 1)
    delta = torch.where(has_cs, ddelta, 0)
    rung = torch.cumsum(delta, dim=0) & ((1 << ubits) - 1)  # entry runbits are zero
    rung0 = rung == 0
    flag = (w >> cs_len) & 1  # the all-zero flag, within the same window
    kind = torch.where(rung0, torch.where(flag == 1, KIND_BITS, KIND_ZERO), KIND_NORMAL)
    val_pos = goff + cs_len + rung0.to(torch.int64)
    return (kind.reshape(-1).to(torch.uint8), val_pos.reshape(-1), rung.reshape(-1),
            torch.zeros_like(w).reshape(-1))


def ix_regs(words32, goff, nreg: int):
    """Each group's register window as the JAX package gathers it: words
    (goff >> 5) + j for j < nreg (a negative index counts from the end, then
    indices clamp into the stream), then two zero words -> (ngroups,
    nreg + 2) int64."""
    w = words_u32(words32)
    n32 = w.shape[0]
    idx = (goff.to(torch.int64) >> 5)[:, None] + torch.arange(nreg, device=goff.device)
    idx = torch.where(idx < 0, idx + n32, idx).clamp(0, n32 - 1)
    regs = w[idx]
    return torch.cat([regs, torch.zeros_like(regs[:, :2])], dim=1)


def ix_parse(regs, goff, tbits: int, nbands: int, per_tile: int):
    """Codeswitch parse and band rung chain of "ix" groups (the rung chain
    restarts every per_tile groups) -> (off, rung, kind) int64: the first
    value bit within the window, the rung, and 1 group / 2 bits / 0 zero."""
    ubits = {8: 3, 16: 4, 32: 5, 64: 6}[tbits]
    off0 = goff.to(torch.int64) & 31
    w0 = window64(regs, off0)
    has_cs = (w0 & 1) == 1
    dlen, ddelta = dsw_arith(srl(w0, 1), ubits)
    cs_len = torch.where(has_cs, dlen, 1)
    delta = torch.where(has_cs, ddelta, 0)
    rung = torch.cumsum(delta.reshape(-1, per_tile // nbands, nbands), dim=1)
    rung = rung.reshape(-1) & ((1 << ubits) - 1)
    rung0 = rung == 0
    flag = (w0 >> cs_len) & 1
    kind = torch.where(rung0, torch.where(flag == 1, 2, 0), 1)
    return off0 + cs_len + rung0.to(torch.int64), rung, kind


def ix_walk(regs, off, rung, kind, tbits: int):
    """The 16-value walk of decode_indexed_narrow's XLA formulation on
    register windows (ix_regs) -> (ngroups, B2) int64 mag-sign values.

    u8 keeps a 64-bit accumulator refilled a word at a time (words past the
    window read zero), u16 decodes 3 values per 64-bit window, u32/u64 one
    (u64 with the rung-63 65-bit form)."""
    off, rung = off.to(torch.int64), rung.to(torch.int64)
    isg, isb = kind == 1, kind == 2
    nreg = regs.shape[1] - 2
    outs = []

    def value(ww):
        gv, gl = _vlc_decode_arith(ww, rung)
        outs.append(torch.where(isg, gv, torch.where(isb, ww & 1, 0)))
        return torch.where(isg, gl, isb.to(torch.int64))

    if tbits == 8:
        def reg(k):  # zero outside [0, nreg - 1]
            k = torch.where((k < 0) | (k > nreg - 1), nreg, k)
            return regs.gather(1, k[:, None])[:, 0]

        k, sh = off >> 5, off & 31
        acc = srl(reg(k) | (reg(k + 1) << 32), sh)
        navail, k = 64 - sh, k + 2
        for v0 in range(0, B2, 3):
            shift = torch.zeros_like(off)
            for _ in range(min(3, B2 - v0)):
                shift = shift + value(srl(acc, shift) & M32)
            acc, navail = srl(acc, shift), navail - shift
            need = navail < 27  # a 3-value step uses <= 27 bits
            acc = acc | torch.where(need, reg(k) << torch.where(need, navail, 0), 0)
            navail, k = navail + 32 * need, k + need
    elif tbits == 16:
        for v0 in range(0, B2, 3):
            w = window64(regs, off)
            shift = torch.zeros_like(off)
            for _ in range(min(3, B2 - v0)):
                shift = shift + value(srl(w, shift) & M32)
            off = off + shift
    else:
        for _ in range(B2):
            w = window64(regs, off)
            ln = value(w)
            if tbits == 64:
                # rung-63 long form: bit 62 of the value is the stream bit
                # just past the 64-bit window
                extra = window64(regs, off + 64) & 1
                outs[-1] = outs[-1] | torch.where(isg & (ln == 65), extra << 62, 0)
            off = off + ln
    return torch.stack(outs, dim=-1)


def decode_indexed_narrow(words32, glens, nblocks: int, nbands: int,
                          apply_step: bool, tbits: int = 8, ntiles: int = 1,
                          tile_words32: int = 0, nreg: int | None = None,
                          fused: int | None = None):
    """The "ix" sidecar decode, all element widths -> (ngroups, B2) int64
    mag-sign groups.

    words32 (n32,) int32 stream words; glens (ntiles * nblocks * nbands,)
    per-group bit lengths.  ntiles > 1 decodes a batch of same-shape streams
    laid out tile_words32 words apart; bit cursors and rung chains restart
    at every tile.  Bit cursors are int32, as in the JAX package (callers
    keep the total under 2^31).  nreg: window words per group (the
    sidecar's own bound, api._indexed_nreg).

    fused (K4's staged span R, from api._fused_ix_params): the fused walk
    K4 parses and walks every group.  fused=None: the windows are gathered
    here and K5 walks them.  Each wrapper runs its kernel on a CUDA tensor
    and its plain twin on a CPU tensor.
    """
    from .fusedwin_cuda import wavefront_fused
    from .wavefront_cuda import wavefront8, wavefront_wide

    per_tile = nblocks * nbands
    g2 = glens.reshape(ntiles, per_tile).to(torch.int64)
    tbase = torch.arange(ntiles, device=glens.device)[:, None] * (tile_words32 * 32)
    goff = (torch.cumsum(g2, dim=1) - g2 + tbase).reshape(-1).to(torch.int32)
    nreg = nreg or _NREG_IX[tbits]
    if fused is not None:
        g, _ = wavefront_fused(words32, goff, nreg, fused, tbits, nbands=nbands,
                               per_tile=per_tile, apply_step=apply_step)
        return g
    regs = ix_regs(words32, goff, nreg)
    off, rung, kind = ix_parse(regs, goff, tbits, nbands, per_tile)
    args = (regs[:, :nreg].to(torch.int32).contiguous(), off.to(torch.int32),
            rung.to(torch.int32), kind.to(torch.int32), nreg)
    if tbits == 8:
        g = wavefront8(*args).to(torch.int64) & M32
    else:
        g = wavefront_wide(*args, tbits)
    return step_restore(g, rung, kind == 1) if apply_step else g


def decode_groups(words32, base, off, rung, kind, cf, nreg: int, R: int, tbits: int,
                  apply_step: bool):
    """The decode of the groups that the serial walk (or an "ib" sidecar)
    located -> (ngroups, B2) int64 mag-sign values: u32 patterns for u8 and
    u16, u64 for u32 and u64, as qb3_tpu's are.

    Counterpart of qb3_tpu's decode_groups_fused (u8/u16) and decode_groups
    (u32/u64) for every kind: NORMAL, ZERO, BITS and the best modes' CF, CF0
    and IDX.  words32 (n32,) int32 stream words; base (ngroups,) int32 each
    group's window word (its first value bit >> 5), off the bit within it
    (& 31), rung and kind (K5's codes, K5_KIND) (ngroups,) int32; cf
    (ngroups,) int64 u64 common factors (read for CF and CF0 groups), or
    None where no group is either; nreg
    window words per group, enough for the longest group from any bit phase
    (_NREG_IX), so no value reads past its window; R the words each K7
    block stages (gather_span).  K7 gathers the windows (zero past the
    stream), K5a (u8) or K5b walks them, CF groups' step restore and
    multiply-back and CF0 groups' expansion included, and BASE and best
    modes restore the step bit of the group-coded (kind 1) groups.  Each
    wrapper runs its kernel on a CUDA tensor and its plain twin on a CPU
    tensor.
    """
    from .gather_cuda import gather_slabs
    from .wavefront_cuda import wavefront8, wavefront_wide

    regs = gather_slabs(words32, base, nreg, R)
    if tbits == 8:
        g = wavefront8(regs, off, rung, kind, nreg, cf).to(torch.int64) & M32
    else:
        g = wavefront_wide(regs, off, rung, kind, nreg, tbits, cf)
    return step_restore(g, rung.to(torch.int64), kind == 1) if apply_step else g


def _undelta_cumsum_blocks(s):
    """Hierarchical scan-order prefix sum of deltas, block-major.

    s: (..., nblocks, C, B2) int64.  The scan sequence per band is
    blocks-major-then-lanes; the prefix decomposes into an in-lane cumsum
    plus a block-level carry chain, all in the native layout.  int64 sums
    wrap, so the result is exact mod 2^64 and, masked, mod 2^tbits.
    """
    cl = torch.cumsum(s, dim=-1)
    tl = cl[..., B2 - 1]  # (..., nblocks, C) block totals
    ctl = torch.cumsum(tl, dim=-2)
    carry = torch.cat([torch.zeros_like(ctl[..., :1, :]), ctl[..., :-1, :]], dim=-2)
    return cl + carry[..., None]


def _lane_of(order: int) -> np.ndarray:
    """(B, B) lane index of each in-block raster position along the curve."""
    lane_of = np.zeros((B, B), dtype=np.int64)
    for i, (dy, dx) in enumerate(curve_offsets(order)):
        lane_of[dy, dx] = i
    return lane_of


def _band_add(img, cband, tbits: int):
    """Band-delta add pass (QB3decode.h:729-737) on (..., C) images."""
    core = img[..., table(tuple(int(c) for c in cband), img.device)]
    dep = table(tuple(int(c != i) for i, c in enumerate(cband)), img.device)
    return wrap(img + core * dep, tbits)


def reconstruct_batch(groups, h: int, w: int, nbands: int, order: int,
                      cband: tuple[int, ...], tbits: int):
    """Flat multi-tile reconstruct: (ntiles, nblocks, C, B2) mag-sign groups
    -> (ntiles, H, W, C) int64 images, 4-aligned tiles, fresh band state per
    tile."""
    if h % B or w % B:
        raise ValueError("batch reconstruct requires 4-aligned tiles")
    ntiles = groups.shape[0]
    v = wrap(_undelta_cumsum_blocks(smag(groups, tbits)), tbits)
    inv = table(tuple(_lane_of(order).reshape(-1).tolist()), groups.device)
    t = v[..., inv].reshape(ntiles, h // B, w // B, nbands, B, B)
    img = t.permute(0, 1, 4, 2, 5, 3).reshape(ntiles, h, w, nbands)
    return _band_add(img, cband, tbits)


def reconstruct(groups, entry_prev, h: int, w: int, nbands: int, order: int,
                cband: tuple[int, ...], tbits: int):
    """Mag-sign groups (nblocks, C, B2) -> ((H, W, C) int64 image, exit_prev).

    Prefix-sum un-delta in scan order, inverse scan gather (later blocks win
    on the overlapped edge pixels, matching the serial write order), then the
    band-delta add pass.
    """
    v = _undelta_cumsum_blocks(smag(groups, tbits))
    v = wrap(v + entry_prev[None, :, None], tbits)
    exit_prev = v[-1, :, B2 - 1]
    lane_of = _lane_of(order)
    if h % B == 0 and w % B == 0:
        # aligned: static inverse curve permutation + layout transposes
        inv = table(tuple(lane_of.reshape(-1).tolist()), groups.device)
        t = v[:, :, inv].reshape(h // B, w // B, nbands, B, B)
        img = t.permute(0, 3, 1, 4, 2).reshape(h, w, nbands)
    else:
        ys = block_origins(h)
        xs = block_origins(w)
        nby, nbx = len(ys), len(xs)
        # pixel -> providing block (the last block in scan order wins on overlap)
        py = np.arange(h)
        px = np.arange(w)
        by = np.where(py >= ys[-1], nby - 1, np.minimum(py // B, nby - 1))
        bx = np.where(px >= xs[-1], nbx - 1, np.minimum(px // B, nbx - 1))
        lane = lane_of[(py[:, None] - ys[by][:, None]), (px[None, :] - xs[bx][None, :])]
        src = (by[:, None] * nbx + bx[None, :]) * B2 + lane  # (h, w) into (nblocks*B2)
        flat = v.transpose(0, 1).reshape(nbands, -1)  # (C, nblocks*B2)
        img = flat[:, torch.as_tensor(src.reshape(-1), device=groups.device)]
        img = img.reshape(nbands, h, w).permute(1, 2, 0)
    return _band_add(img, cband, tbits), exit_prev
