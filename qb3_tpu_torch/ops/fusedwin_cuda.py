"""Wrapper of the CUDA kernel K4 (the fused "ix" window walk), its plain
PyTorch twin, launch counter and host-side sizing of its staged span.

Counterpart of qb3_tpu/ops/fusedwin_pallas.py.  The wrapper takes the twin
for a CPU tensor and launches csrc/fusedwin.cu for a CUDA tensor; there is
no fallback from one to the other.  Both take each group's start bit goff
(not the TPU kernel's 8-word-aligned base8 / phase pair) and read the
register window of decode_indexed_narrow's XLA walk: NREG words from word
goff >> 5 with JAX's gather rules, so both equal the JAX package's walk on
the CPU bit for bit, damaged streams included (ops/decode.ix_walk).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..constants import B2
from .decode import ix_parse, ix_regs, ix_walk, step_restore
from .gather_cuda import gather_span
from .pack_cuda import on_cpu, require, stream_ptr

_K4 = _build.Kernel("qb3_wavefront_fused")

FUSED_G = 128  # groups a K4 round, whose span it stages (csrc/fusedwin.cu kThreads)
FUSED_MAX_R = 8192  # staged words a round (32 KB of shared memory)
BANDS_PER_WORD = 10  # band sums a look-back state word holds (csrc/fusedwin.cu)


def ix_window_R(goff: np.ndarray, nreg: int) -> int:
    """Words K4 stages a round (host side): from each round's first group's
    base word, rounded down to 4, through the last word any of its groups'
    windows reads; capped at FUSED_MAX_R (words past the span are read from
    the stream, so R moves speed, never values)."""
    return gather_span(np.asarray(goff, np.int64) >> 5, nreg, FUSED_G, FUSED_MAX_R)


def wavefront_fused_plain(words32, goff, nreg: int, tbits: int,
                          nbands: int | None = None, off=None, rung=None,
                          kind=None, per_tile: int = 0, apply_step: bool = False):
    """K4's twin: the XLA walk of qb3_tpu's decode_indexed_narrow ->
    ((ngroups, B2) int64, rung (ngroups,) int32) with nbands, else the
    (ngroups, B2) int64 values alone."""
    regs = ix_regs(words32, goff, nreg)
    if nbands is not None:
        off, rung, kind = ix_parse(regs, goff, tbits, nbands, per_tile or goff.shape[0])
    rung = rung.to(torch.int64)
    g = ix_walk(regs, off.to(torch.int64), rung, kind, tbits)
    if apply_step:
        g = step_restore(g, rung, kind == 1)
    return (g, rung.to(torch.int32)) if nbands is not None else g


def wavefront_fused(words32, goff, nreg: int, R: int, tbits: int,
                    nbands: int | None = None, off=None, rung=None, kind=None,
                    per_tile: int = 0, apply_step: bool = False):
    """K4: the fused "ix" walk.

    words32 (n32,) int32 stream words, 16-byte aligned; goff (ngroups,)
    int32 group start bits; nreg window words per group; R staged words a
    round of FUSED_G groups (ix_window_R).  nbands given: parse the
    codeswitches and run the band rung chain in the kernel, restarting every
    per_tile groups (0: one stream) -> ((ngroups, B2) int64 mag-sign values,
    rung (ngroups,) int32).  nbands None: off (first value bit within the
    window), rung and kind (ngroups,) int32 from the caller -> (ngroups, B2)
    int64.  apply_step adds the BASE-mode step restore.
    """
    if on_cpu(words32):
        return wavefront_fused_plain(words32, goff, nreg, tbits, nbands, off, rung,
                                     kind, per_tile, apply_step)
    dev = words32.device
    require(words32, torch.int32, "words32", 1)
    require(goff, torch.int32, "goff", 1, dev)
    if words32.data_ptr() % 16:
        raise ValueError("words32 must be 16-byte aligned")
    if not (4 <= R <= FUSED_MAX_R and R % 4 == 0):
        raise ValueError(f"staged span R={R}: want a multiple of 4 in [4, {FUSED_MAX_R}]")
    ngroups = goff.shape[0]
    out = torch.empty(ngroups, B2, dtype=torch.int64, device=dev)
    null = 0
    if nbands is not None:
        per_tile = per_tile or ngroups
        if ngroups % per_tile or per_tile % nbands:
            raise ValueError(f"{ngroups} groups do not split into tiles of {per_tile} "
                             f"with {nbands} bands")
        rung_out = torch.empty(ngroups, dtype=torch.int32, device=dev)
        # the look-back's ticket and state words (at most a block a round),
        # zeroed by the kernel's entry point
        scratch = torch.empty(1 + -(-ngroups // FUSED_G) * -(-nbands // BANDS_PER_WORD),
                              dtype=torch.int64, device=dev)
        ptrs = (null, null, null, out.data_ptr(), rung_out.data_ptr(), scratch.data_ptr())
    else:
        for x, n in ((off, "off"), (rung, "rung"), (kind, "kind")):
            require(x, torch.int32, n, 1, dev)
            if x.shape[0] != ngroups:
                raise ValueError(f"{n}: {x.shape[0]} groups, goff has {ngroups}")
        ptrs = (off.data_ptr(), rung.data_ptr(), kind.data_ptr(), out.data_ptr(), null, null)
    _K4(words32.data_ptr(), words32.shape[0], goff.data_ptr(), ngroups, nreg, R, tbits,
        nbands or 0, per_tile, int(apply_step), *ptrs, stream_ptr(dev))
    wavefront_fused.launches += 1
    return (out, rung_out) if nbands is not None else out


wavefront_fused.launches = 0
