"""Wrapper of the CUDA kernel K7 (gather_slabs), its plain PyTorch twin,
launch counter and the host-side sizing of its staged span.

Counterpart of qb3_tpu/ops/pack_pallas.py's gather_slabs: each group's
window of W consecutive stream words at its word offset.  On the decode
without a sidecar (ops/decode.decode_groups) it gathers the register
windows K5 walks, where qb3_tpu gathers them with XLA indexing or, on the
TPU, the MXU one-hot gather_slabs_onehot8.  The wrapper takes the twin for
a CPU tensor and launches csrc/gather.cu for a CUDA tensor; there is no
fallback from one to the other.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from .pack_cuda import on_cpu, require, stream_ptr

GATHER_G = 128  # groups per K7 block (csrc/gather.cu kGroups)
GATHER_MAX_R = 8192  # staged words per block (32 KB of shared memory)
_K7 = _build.Kernel("qb3_gather_slabs")


def gather_span(base: np.ndarray, W: int, G: int = GATHER_G, cap: int = GATHER_MAX_R) -> int:
    """Words a block of G groups stages (host side): from the block's first
    base word, rounded down to 4, through the last word any of its windows
    reads; a multiple of 4, capped at `cap` (words past the span are read
    from the stream, so the span moves speed, never values)."""
    base = np.asarray(base, np.int64)
    if base.size == 0:
        return 4
    starts = np.arange(0, base.size, G)
    span = np.maximum.reduceat(base, starts) - (base[starts] & ~3) + W
    return int(min(max(-(-int(span.max()) // 4) * 4, 4), cap))


def gather_slabs_plain(words32, base, W: int):
    """K7's twin: out[g, j] = words32[base[g] + j], zero outside the
    stream."""
    idx = base.to(torch.int64)[:, None] + torch.arange(W, device=words32.device)
    live = (idx >= 0) & (idx < words32.shape[0])
    return torch.where(live, words32[torch.where(live, idx, 0)], 0)


def gather_slabs(words32, base, W: int, R: int):
    """K7: words32 (n32,) int32 u32 stream words, 16-byte aligned; base
    (ngroups,) int32 word offsets (sorted on the decode path); R the words
    each block stages (gather_span) -> (ngroups, W) int32.  No group, no
    launch."""
    if on_cpu(words32):
        return gather_slabs_plain(words32, base, W)
    dev = words32.device
    require(words32, torch.int32, "words32", 1)
    require(base, torch.int32, "base", 1, dev)
    ptr = words32.data_ptr()
    if ptr % 16:
        raise ValueError("words32 must be 16-byte aligned")
    if not (4 <= R <= GATHER_MAX_R and R % 4 == 0):
        raise ValueError(f"staged span R={R}: want a multiple of 4 in [4, {GATHER_MAX_R}]")
    ngroups = base.shape[0]
    out = torch.empty(ngroups, W, dtype=torch.int32, device=dev)
    if ngroups:
        _K7(ptr, words32.shape[0], base.data_ptr(), ngroups, W, R, out.data_ptr(), stream_ptr(dev))
        gather_slabs.launches += 1
    return out


gather_slabs.launches = 0
