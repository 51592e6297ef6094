"""Wrapper of the CUDA kernel K9 (the fast encoder's phase A in one pass),
with its plain PyTorch twin and launch counter.

K9 replaces no TPU kernel: qb3_tpu's fast phase A is XLA ops.  Its twin is
ops/encode.encode_fast_blocks, which the best phase A and the sharded paths
take apart and which this module leaves as it is.  The wrapper takes the
twin for a CPU tensor and launches its kernel (csrc/phase_a.cu) for a CUDA
tensor; there is no fallback from one to the other.  Its ``launches``
attribute counts its kernel launches.
"""

from __future__ import annotations

import math

import torch

from .. import _build
from ..constants import B
from .bitutils import table
from .encode import encode_fast_blocks
from .pack_cuda import _strides, on_cpu, require, stream_ptr

_K9 = _build.Kernel("qb3_phase_a_fast")
MAX_BANDS = 256  # bands the kernel takes (csrc/phase_a.cu kMaxBands)


def phase_a_args(img, entry_prev, entry_runbits, order: int, cband, skipstep: bool,
                 tbits: int, with_rungs: bool):
    """Check K9's inputs and allocate its outputs -> (the C entry point's
    arguments but the stream, and encode_fast_blocks' outputs: codes, lens,
    exit_prev, exit_runbits, and rung where with_rungs).  The codes and
    lengths share one buffer, the rungs and the exit state another."""
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
    ntiles = math.prod(lead)
    nblocks = -(-h // B) * -(-w // B)
    ngroups, nsym = nblocks * nb, 33 if tbits == 64 else 17
    n = ntiles * ngroups * nsym
    sym = torch.empty(n + (n + 1) // 2, dtype=torch.int64, device=dev)
    codes = sym.as_strided((*lead, ngroups, nsym), _strides((*lead, ngroups, nsym)), 0)
    lens = sym.view(torch.int32).as_strided(codes.shape, codes.stride(), 2 * n)
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
