"""Wrapper of the CUDA kernel K6 (place_slabs), its plain PyTorch twin and
launch counter.

Counterpart of qb3_tpu/ops/pack_pallas.py's place_slabs: add W-word slabs
into a zeroed stream at sorted word bases.  Contributions touch disjoint
bits, so the sum equals their OR.  In the port it is the device stitch
(stitch.stitch_words_device), which the strip encoder runs once per image;
qb3_tpu calls its kernel only from the pack variant chosen by QB3_PACK,
which the port does not have.  The wrapper takes the twin for a CPU tensor
and launches csrc/place.cu for a CUDA tensor; there is no fallback from one
to the other.
"""

from __future__ import annotations

import torch

from .. import _build
from .pack_cuda import on_cpu, require, stream_ptr

_K6 = _build.Kernel("qb3_place_slabs")


def place_slabs_plain(slab, base, n_words: int):
    """K6's twin, the scatter-add of qb3_tpu's pack_groups (bitpack.py:126-128):
    out[base[g] + j] += slab[g, j], words at or past n_words dropped."""
    W = slab.shape[1]
    idx = base.to(torch.int64)[:, None] + torch.arange(W, device=slab.device)
    live = idx < n_words
    out = torch.zeros(n_words, dtype=torch.int32, device=slab.device)
    return out.index_add_(0, torch.where(live, idx, 0).reshape(-1),
                          torch.where(live, slab, 0).reshape(-1))


def place_slabs(slab, base, n_words: int):
    """K6: slab (ngroups, W) int32 u32 patterns, base (ngroups,) int32 word
    offsets (sorted on the stitch; the kernel does not need them sorted) ->
    (n_words,) int32, zero where no slab lands."""
    if on_cpu(slab):
        return place_slabs_plain(slab, base, n_words)
    dev = slab.device
    require(slab, torch.int32, "slab", 2)
    require(base, torch.int32, "base", 1, dev)
    if base.shape[0] != slab.shape[0]:
        raise ValueError(f"base has {base.shape[0]} entries for {slab.shape[0]} slabs")
    out = torch.zeros(n_words, dtype=torch.int32, device=dev)
    if slab.numel() == 0:
        return out
    _K6(slab.data_ptr(), base.data_ptr(), slab.shape[0], slab.shape[1], out.data_ptr(), n_words,
        stream_ptr(dev))
    place_slabs.launches += 1
    return out


place_slabs.launches = 0
