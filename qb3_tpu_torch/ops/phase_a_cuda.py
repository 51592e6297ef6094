"""Wrappers of the CUDA kernels K9 (the fast encoder's phase A in one pass)
and K10 (the best modes' phase A in one pass), with their plain PyTorch
twins and launch counters.

Neither replaces a TPU kernel: qb3_tpu's phase A is XLA ops.  K9's twin is
ops/encode.encode_fast_blocks, which the best phase A and the sharded paths
take apart; K10's is ops/encode_best.encode_best_blocks, which the sharded
best encode keeps for its exchange hooks.  This module leaves both as they
are.  A wrapper takes its twin for a CPU tensor and launches its kernel
(csrc/phase_a.cu, csrc/phase_a_best.cu) for a CUDA tensor; there is no
fallback from one to the other.  Each wrapper's ``launches`` attribute
counts its kernel launches.
"""

from __future__ import annotations

import math

import torch

from .. import _build
from ..constants import B
from .bitutils import table
from .encode import encode_fast_blocks
from .encode_best import encode_best_blocks
from .pack_cuda import _strides, on_cpu, require, stream_ptr

_K9 = _build.Kernel("qb3_phase_a_fast")
_K10 = _build.Kernel("qb3_phase_a_best")
MAX_BANDS = 256  # bands the kernels take (csrc/phase_a.cu, phase_a_best.cu kMaxBands)


def _checked(img, entry_prev, entry_runbits, cband, tbits: int):
    """Check the inputs both kernels take -> (lead, H, W, C)."""
    if tbits not in (8, 16, 32, 64):
        raise ValueError(f"tbits {tbits}: the kernel takes 8, 16, 32 or 64")
    require(img, torch.int64, "img")
    *lead, h, w, nb = img.shape
    if h < B or w < B:
        raise ValueError(f"image {h}x{w}: the kernel takes sides of {B} or more")
    if not 1 <= nb <= MAX_BANDS:
        raise ValueError(f"{nb} bands: the kernel takes 1 to {MAX_BANDS}")
    if len(cband) != nb or not all(0 <= int(c) < nb for c in cband):
        raise ValueError(f"cband {tuple(cband)}: one core band in [0, {nb}) a band")
    dev = img.device
    state = (*lead, nb)
    require(entry_prev, torch.int64, "entry_prev", len(state), dev)
    if entry_runbits.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"entry_runbits: expected int32 or int64, got {entry_runbits.dtype}")
    require(entry_runbits, entry_runbits.dtype, "entry_runbits", len(state), dev)
    if tuple(entry_prev.shape) != state or tuple(entry_runbits.shape) != state:
        raise ValueError(f"entry state {tuple(entry_prev.shape)}, "
                         f"{tuple(entry_runbits.shape)}: expected {state}")
    return lead, h, w, nb


def _symbols(lead, ngroups: int, nsym: int, dev):
    """codes (*lead, ngroups, nsym) int64 and lens int32, in one buffer."""
    n = math.prod(lead) * ngroups * nsym
    sym = torch.empty(n + (n + 1) // 2, dtype=torch.int64, device=dev)
    codes = sym.as_strided((*lead, ngroups, nsym), _strides((*lead, ngroups, nsym)), 0)
    return codes, sym.view(torch.int32).as_strided(codes.shape, codes.stride(), 2 * n)


def phase_a_args(img, entry_prev, entry_runbits, order: int, cband, skipstep: bool,
                 tbits: int, with_rungs: bool):
    """Check K9's inputs and allocate its outputs -> (the C entry point's
    arguments but the stream, and encode_fast_blocks' outputs: codes, lens,
    exit_prev, exit_runbits, and rung where with_rungs).  The codes and
    lengths share one buffer, the rungs and the exit state another."""
    lead, h, w, nb = _checked(img, entry_prev, entry_runbits, cband, tbits)
    dev = img.device
    state = (*lead, nb)
    ntiles = math.prod(lead)
    nblocks = -(-h // B) * -(-w // B)
    ngroups = nblocks * nb
    codes, lens = _symbols(lead, ngroups, 33 if tbits == 64 else 17, dev)
    small = torch.empty(ntiles * (ngroups * with_rungs + 2 * nb), dtype=torch.int64, device=dev)
    exit_prev = small.as_strided(state, _strides(state), 0)
    exit_run = small.as_strided(state, _strides(state), ntiles * nb)
    out = (codes, lens, exit_prev, exit_run)
    rung_ptr = None
    if with_rungs:
        rung = small.as_strided((*lead, nblocks, nb), _strides((*lead, nblocks, nb)),
                                2 * ntiles * nb)
        out, rung_ptr = out + (rung,), rung.data_ptr()
    args = (img.data_ptr(), entry_prev.data_ptr(), entry_runbits.data_ptr(),
            int(entry_runbits.dtype == torch.int64),
            table(tuple(int(c) for c in cband), dev).data_ptr(), ntiles, h, w, nb, tbits,
            order, int(skipstep), codes.data_ptr(), lens.data_ptr(), rung_ptr,
            exit_prev.data_ptr(), exit_run.data_ptr())
    return args, out


def phase_a_fast(img, entry_prev, entry_runbits, order: int, cband: tuple[int, ...],
                 skipstep: bool, tbits: int, with_rungs: bool = False, lanewise=None):
    """K9: the fast encoder's phase A (FTL / BASE) in one launch, returning
    what encode_fast_blocks returns, with the same shapes, dtypes and values.

    img (..., H, W, C) int64 carrier of tbits-wide values, H and W at least
    4, C at most 256; entry_prev (..., C) int64, entry_runbits (..., C)
    int32 or int64, contiguous.  Returns (codes int64, lens int32,
    exit_prev, exit_runbits), codes / lens (..., ngroups, nsym) in stream
    order, and with_rungs the rungs (..., nblocks, C).  lanewise picks one
    of the twin's two formulations of the same values; the kernel has one."""
    if on_cpu(img):
        return encode_fast_blocks(img, entry_prev, entry_runbits, order, cband, skipstep, tbits,
                                  with_rungs, lanewise)
    args, out = phase_a_args(img, entry_prev, entry_runbits, order, cband, skipstep, tbits,
                             with_rungs)
    if out[0].numel():
        _K9(*args, stream_ptr(img.device))
        phase_a_fast.launches += 1
    return out


phase_a_fast.launches = 0


def phase_a_best_args(img, entry_prev, entry_runbits, entry_cf, order: int, cband, tbits: int):
    """Check K10's inputs and allocate its outputs -> (the C entry point's
    arguments but the stream, and encode_best_blocks' nine outputs: codes,
    lens, exit_prev, exit_runbits, exit_cf, meta16, cfv, post_runbits,
    pcf_in).  The codes and lengths share one buffer, the other outputs
    another, and the look-back's ticket, state and CF values a third, sized
    for a CTA a raster block (the kernel takes at least one a CTA and zeroes
    what its CTAs use)."""
    lead, h, w, nb = _checked(img, entry_prev, entry_runbits, cband, tbits)
    dev = img.device
    state = (*lead, nb)
    require(entry_cf, torch.int64, "entry_cf", len(state), dev)
    if tuple(entry_cf.shape) != state:
        raise ValueError(f"entry_cf {tuple(entry_cf.shape)}: expected {state}")
    ntiles = math.prod(lead)
    nblocks = -(-h // B) * -(-w // B)
    ngroups = nblocks * nb
    codes, lens = _symbols(lead, ngroups, 43 if tbits == 64 else 27, dev)
    n = ntiles * ngroups
    grp = torch.empty(3 * n + 3 * ntiles * nb + (n + 1) // 2, dtype=torch.int64, device=dev)
    per_group, per_block = (*lead, ngroups), (*lead, nblocks, nb)
    cfv = grp.as_strided(per_group, _strides(per_group), 0)
    post_run = grp.as_strided(per_block, _strides(per_block), n)
    pcf_in = grp.as_strided(per_block, _strides(per_block), 2 * n)
    exits = [grp.as_strided(state, _strides(state), 3 * n + k * ntiles * nb) for k in range(3)]
    meta16 = grp.view(torch.int32).as_strided(per_group, _strides(per_group),
                                              2 * (3 * n + 3 * ntiles * nb))
    nscratch = 1 + 2 * n
    scratch = torch.empty(nscratch, dtype=torch.int64, device=dev)
    args = (img.data_ptr(), entry_prev.data_ptr(), entry_runbits.data_ptr(),
            int(entry_runbits.dtype == torch.int64), entry_cf.data_ptr(),
            table(tuple(int(c) for c in cband), dev).data_ptr(), ntiles, h, w, nb, tbits, order,
            codes.data_ptr(), lens.data_ptr(), meta16.data_ptr(), cfv.data_ptr(),
            post_run.data_ptr(), pcf_in.data_ptr(), *(e.data_ptr() for e in exits),
            scratch.data_ptr(), nscratch)
    return args, (codes, lens, *exits, meta16, cfv, post_run, pcf_in)


def phase_a_best(img, entry_prev, entry_runbits, entry_cf, order: int, cband: tuple[int, ...],
                 tbits: int):
    """K10: the best modes' phase A (CF / CF_H) in one launch, returning
    what encode_best_blocks returns, with the same shapes, dtypes and values.

    img (..., H, W, C) int64 carrier of tbits-wide values, H and W at least
    4, C at most 256; entry_prev and entry_cf (..., C) int64, entry_runbits
    (..., C) int32 or int64, contiguous.  Returns (codes int64, lens int32,
    exit_prev, exit_runbits, exit_cf, meta16 int32, cfv, post_runbits,
    pcf_in), codes / lens (..., ngroups, nsym) in stream order."""
    if on_cpu(img):
        return encode_best_blocks(img, entry_prev, entry_runbits, entry_cf, order, cband, tbits)
    args, out = phase_a_best_args(img, entry_prev, entry_runbits, entry_cf, order, cband, tbits)
    if out[0].numel():
        _K10(*args, stream_ptr(img.device))
        phase_a_best.launches += 1
    return out


phase_a_best.launches = 0
