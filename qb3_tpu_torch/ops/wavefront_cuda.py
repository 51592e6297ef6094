"""Wrappers of the CUDA kernels K5a (wavefront8) and K5b (wavefront_wide),
their plain PyTorch twins and launch counters.

Counterpart of qb3_tpu/ops/wavefront_pallas.py: the 16-value walk of groups
on register windows gathered beforehand (the fused=None branch of
ops/decode.decode_indexed_narrow, and ops/decode.decode_groups), extended
to the best modes' kinds that qb3_tpu decodes in XLA after its walk
(decode_groups_fused / decode_groups): CF (the group VLC, the step restore,
the multiply-back by cf), CF0 (one bit a value, each set one the mag-sign
of -cf) and IDX (16 rung-2 index codes, then up to 8 uniques in the
single-value context).  A wrapper takes its twin for a CPU tensor and
launches csrc/wavefront.cu for a CUDA tensor; there is no fallback from one
to the other.  On kinds 0-2 both follow the TPU kernels on any input in
their domain: off in [0, 64), rung below the type's bit width; window
words past NREG read as zero.  A kernel block stages its groups' windows in
shared memory, so the kernels take nreg up to K5_MAX_NREG.
"""

from __future__ import annotations

import torch

from .. import _build
from ..constants import B2
from .bitutils import M32, magsabs, srl
from .decode import _vlc_decode_arith, _vlc_decode_plain, _vlc_decode_single, step_restore
from .pack_cuda import on_cpu, require, stream_ptr

_K5A = _build.Kernel("qb3_wavefront8")
_K5B = _build.Kernel("qb3_wavefront_wide")

KIND_GROUP, KIND_BITS, KIND_CF, KIND_CF0, KIND_IDX = 1, 2, 3, 4, 5  # K5's codes
K5_MAX_NREG = 384  # window words a group on the card (csrc/wavefront.cu kMaxNreg)


def _walk_plain(regs_arr, off, rung, kind, cf, nreg: int, tbits: int):
    regs = regs_arr.to(torch.int64) & M32
    regs = torch.cat([regs, torch.zeros_like(regs[:, :3])], dim=1)
    off, rung = off.to(torch.int64), rung.to(torch.int64)
    isg = (kind == KIND_GROUP) | (kind == KIND_CF)
    isb = (kind == KIND_BITS) | (kind == KIND_CF0)
    isi = kind == KIND_IDX
    anyi = bool(isi.any())  # no index decode where no group is IDX
    two = torch.full_like(rung, 2)

    def reg(k):  # zero outside [0, nreg - 1]
        k = torch.where((k < 0) | (k > nreg - 1), nreg, k)
        return regs.gather(1, k[:, None])[:, 0]

    def window(k, sh):  # (r0 | r1 << 32 | r2 << 64) >> sh, 64 bits
        return (srl(reg(k) | (reg(k + 1) << 32), sh)
                | torch.where(sh == 0, 0, reg(k + 2) << ((64 - sh) & 63)))

    outs = []

    def value(ww):
        gv, gl = _vlc_decode_arith(ww, rung)
        v, ln = torch.where(isb, ww & 1, 0), isb.to(torch.int64)
        if anyi:
            iv, il = _vlc_decode_plain(ww, two)
            v, ln = torch.where(isi, iv, v), torch.where(isi, il, ln)
        outs.append(torch.where(isg, gv, v))
        return torch.where(isg, gl, ln)

    uniques = []
    if tbits == 8:
        # 64-bit accumulator, refilled a word at a time; the uniques go on
        # reading from it
        sh, k = off & 31, off >> 5
        acc, navail, k = window(k, sh), 64 - sh, k + 2

        def consume(shift, acc, navail, k):
            acc, navail = srl(acc, shift), navail - shift
            need = navail < 27
            acc = acc | torch.where(need, reg(k) << torch.where(need, navail, 0), 0)
            return acc, navail + 32 * need, k + need

        for v0 in range(0, B2, 3):
            shift = torch.zeros_like(off)
            for _ in range(min(3, B2 - v0)):
                shift = shift + value(srl(acc, shift) & M32)
            acc, navail, k = consume(shift, acc, navail, k)
        maxidx = torch.stack(outs, dim=-1).max(-1).values
        for u in range(B2 // 2 if anyi else 0):
            live = isi & (u <= maxidx)
            uv, ul = _vlc_decode_single(acc & M32, rung)
            uniques.append(torch.where(live, uv, 0))
            acc, navail, k = consume(torch.where(live, ul, 0), acc, navail, k)
    else:
        for _ in range(B2):
            # a fresh 64-bit window at each value
            sh, k = off & 31, off >> 5
            w = window(k, sh)
            ln = value(w & M32 if tbits == 16 else w)
            if tbits == 64:
                # rung-63 long form: the 65th stream bit is value bit 62
                extra = srl(reg(k + 2), sh) & 1
                outs[-1] = outs[-1] | torch.where(isg & (ln == 65), extra << 62, 0)
            off = off + ln
        maxidx = torch.stack(outs, dim=-1).max(-1).values
        for u in range(B2 // 2 if anyi else 0):
            live = isi & (u <= maxidx)
            w = window(off >> 5, off & 31)
            uv, ul = _vlc_decode_single(w & M32 if tbits == 16 else w, rung)
            uniques.append(torch.where(live, uv, 0))
            off = off + torch.where(live, ul, 0)
    g = torch.stack(outs, dim=-1)
    if anyi:
        uq = torch.stack(uniques, dim=-1)
        g = torch.where(isi[:, None], uq.gather(1, g.clamp(0, 7)), g)
    # CF: the step restore, then the multiply-back; CF0: -cf per set bit;
    # masked to the type for u8 / u16, wrapping at 64 bits for u32 / u64
    iscf, iscf0 = kind == KIND_CF, kind == KIND_CF0
    if not bool((iscf | iscf0).any()):
        return g
    mask = (1 << tbits) - 1 if tbits <= 16 else -1
    cfv = (torch.zeros_like(rung) if cf is None else cf.to(torch.int64))[:, None]
    g = step_restore(g, rung, iscf)
    g = torch.where(iscf[:, None], (magsabs(g) * (cfv << 1) - (g & 1)) & mask, g)
    neg = (((cfv - 1) << 1) | 1) & mask
    return torch.where(iscf0[:, None], torch.where(g != 0, neg, 0), g)


def wavefront8_plain(regs_arr, off, rung, kind, nreg: int, cf=None):
    """K5a's twin -> (ngroups, B2) int32 (u32 mag-sign values)."""
    return _walk_plain(regs_arr, off, rung, kind, cf, nreg, 8).to(torch.int32)


def wavefront_wide_plain(regs_arr, off, rung, kind, nreg: int, tbits: int, cf=None):
    """K5b's twin -> (ngroups, B2) int64 (u64 mag-sign values)."""
    return _walk_plain(regs_arr, off, rung, kind, cf, nreg, tbits)


def _launch(kernel, regs_arr, off, rung, kind, cf, nreg, out, *extra):
    dev = regs_arr.device
    require(regs_arr, torch.int32, "regs_arr", 2)
    for x, n in ((off, "off"), (rung, "rung"), (kind, "kind"), (cf, "cf")):
        if x is None:
            continue
        require(x, torch.int64 if n == "cf" else torch.int32, n, 1, dev)
        if x.shape[0] != regs_arr.shape[0]:
            raise ValueError(f"{n}: {x.shape[0]} groups, regs_arr has {regs_arr.shape[0]}")
    if regs_arr.shape[1] != nreg:
        raise ValueError(f"regs_arr has {regs_arr.shape[1]} words per group, nreg={nreg}")
    if not 1 <= nreg <= K5_MAX_NREG:
        raise ValueError(f"nreg {nreg}: the kernels take 1 to {K5_MAX_NREG} words per group")
    kernel(regs_arr.data_ptr(), regs_arr.shape[0], nreg, *extra, off.data_ptr(),
           rung.data_ptr(), kind.data_ptr(), None if cf is None else cf.data_ptr(),
           out.data_ptr(), stream_ptr(dev))
    return out


def wavefront8(regs_arr, off, rung, kind, nreg: int, cf=None):
    """K5a: the walk of u8 groups.  regs_arr (ngroups, nreg) int32 u32
    window words (base = group start bit >> 5); off, rung, kind (ngroups,)
    int32; cf (ngroups,) int64 u64 common factors, or None where no group
    is CF or CF0 (read as 0) -> (ngroups, B2) int32 u32 mag-sign values."""
    if on_cpu(regs_arr):
        return wavefront8_plain(regs_arr, off, rung, kind, nreg, cf)
    out = torch.empty(regs_arr.shape[0], B2, dtype=torch.int32, device=regs_arr.device)
    _launch(_K5A, regs_arr, off, rung, kind, cf, nreg, out)
    wavefront8.launches += 1
    return out


def wavefront_wide(regs_arr, off, rung, kind, nreg: int, tbits: int, cf=None):
    """K5b: the walk of u16 / u32 / u64 groups, arguments as K5a ->
    (ngroups, B2) int64 u64 mag-sign values."""
    if tbits not in (16, 32, 64):
        raise ValueError(f"tbits {tbits}: wavefront_wide covers u16/u32/u64")
    if on_cpu(regs_arr):
        return wavefront_wide_plain(regs_arr, off, rung, kind, nreg, tbits, cf)
    out = torch.empty(regs_arr.shape[0], B2, dtype=torch.int64, device=regs_arr.device)
    _launch(_K5B, regs_arr, off, rung, kind, cf, nreg, out, tbits)
    wavefront_wide.launches += 1
    return out


wavefront8.launches = 0
wavefront_wide.launches = 0
