"""Wrappers of the CUDA kernels K5a (wavefront8) and K5b (wavefront_wide),
their plain PyTorch twins and launch counters.

Counterpart of qb3_tpu/ops/wavefront_pallas.py: the 16-value walk of "ix"
groups on register windows gathered beforehand (the fused=None branch of
ops/decode.decode_indexed_narrow).  A wrapper takes its twin for a CPU
tensor and launches csrc/wavefront.cu for a CUDA tensor; there is no
fallback from one to the other.  Both follow the TPU kernels on any input
in their domain: off in [0, 64), kind in {0, 1, 2}, rung below the type's
bit width; window words past NREG read as zero.
"""

from __future__ import annotations

import torch

from ..constants import B2
from .bitutils import M32, srl
from .decode import _vlc_decode_arith
from .pack_cuda import on_cpu, require, stream_ptr


def _walk_plain(regs_arr, off, rung, kind, nreg: int, tbits: int):
    regs = regs_arr.to(torch.int64) & M32
    regs = torch.cat([regs, torch.zeros_like(regs[:, :3])], dim=1)
    off, rung = off.to(torch.int64), rung.to(torch.int64)
    isg, isb = kind == 1, kind == 2

    def reg(k):  # zero outside [0, nreg - 1]
        k = torch.where((k < 0) | (k > nreg - 1), nreg, k)
        return regs.gather(1, k[:, None])[:, 0]

    def window(k, sh):  # (r0 | r1 << 32 | r2 << 64) >> sh, 64 bits
        return (srl(reg(k) | (reg(k + 1) << 32), sh)
                | torch.where(sh == 0, 0, reg(k + 2) << ((64 - sh) & 63)))

    outs = []

    def value(ww):
        gv, gl = _vlc_decode_arith(ww, rung)
        outs.append(torch.where(isg, gv, torch.where(isb, ww & 1, 0)))
        return torch.where(isg, gl, isb.to(torch.int64))

    if tbits == 8:
        # 64-bit accumulator, refilled a word at a time
        sh, k = off & 31, off >> 5
        acc, navail, k = window(k, sh), 64 - sh, k + 2
        for v0 in range(0, B2, 3):
            shift = torch.zeros_like(off)
            for _ in range(min(3, B2 - v0)):
                shift = shift + value(srl(acc, shift) & M32)
            acc, navail = srl(acc, shift), navail - shift
            need = navail < 27
            acc = acc | torch.where(need, reg(k) << torch.where(need, navail, 0), 0)
            navail, k = navail + 32 * need, k + need
        return torch.stack(outs, dim=-1)
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
    return torch.stack(outs, dim=-1)


def wavefront8_plain(regs_arr, off, rung, kind, nreg: int):
    """K5a's twin -> (ngroups, B2) int32 (u32 mag-sign values)."""
    return _walk_plain(regs_arr, off, rung, kind, nreg, 8).to(torch.int32)


def wavefront_wide_plain(regs_arr, off, rung, kind, nreg: int, tbits: int):
    """K5b's twin -> (ngroups, B2) int64 (u64 mag-sign values)."""
    return _walk_plain(regs_arr, off, rung, kind, nreg, tbits)


def _launch(name, regs_arr, off, rung, kind, nreg, out, *extra):
    from .. import _build

    dev = regs_arr.device
    require(regs_arr, torch.int32, "regs_arr", 2)
    for x, n in ((off, "off"), (rung, "rung"), (kind, "kind")):
        require(x, torch.int32, n, 1, dev)
        if x.shape[0] != regs_arr.shape[0]:
            raise ValueError(f"{n}: {x.shape[0]} groups, regs_arr has {regs_arr.shape[0]}")
    if regs_arr.shape[1] != nreg:
        raise ValueError(f"regs_arr has {regs_arr.shape[1]} words per group, nreg={nreg}")
    fn = getattr(_build.load(), name)
    err = fn(regs_arr.data_ptr(), regs_arr.shape[0], nreg, *extra, off.data_ptr(),
             rung.data_ptr(), kind.data_ptr(), out.data_ptr(), stream_ptr(dev))
    _build.check(err, name)
    return out


def wavefront8(regs_arr, off, rung, kind, nreg: int):
    """K5a: the walk of u8 groups.  regs_arr (ngroups, nreg) int32 u32
    window words (base = group start bit >> 5); off, rung, kind (ngroups,)
    int32 -> (ngroups, B2) int32 u32 mag-sign values."""
    if on_cpu(regs_arr):
        return wavefront8_plain(regs_arr, off, rung, kind, nreg)
    out = torch.empty(regs_arr.shape[0], B2, dtype=torch.int32, device=regs_arr.device)
    _launch("qb3_wavefront8", regs_arr, off, rung, kind, nreg, out)
    wavefront8.launches += 1
    return out


def wavefront_wide(regs_arr, off, rung, kind, nreg: int, tbits: int):
    """K5b: the walk of u16 / u32 / u64 groups, arguments as K5a ->
    (ngroups, B2) int64 u64 mag-sign values."""
    if tbits not in (16, 32, 64):
        raise ValueError(f"tbits {tbits}: wavefront_wide covers u16/u32/u64")
    if on_cpu(regs_arr):
        return wavefront_wide_plain(regs_arr, off, rung, kind, nreg, tbits)
    out = torch.empty(regs_arr.shape[0], B2, dtype=torch.int64, device=regs_arr.device)
    _launch("qb3_wavefront_wide", regs_arr, off, rung, kind, nreg, out, tbits)
    wavefront_wide.launches += 1
    return out


wavefront8.launches = 0
wavefront_wide.launches = 0
