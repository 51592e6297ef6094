"""Wrappers of the CUDA kernel K6 (place_slabs), its plain PyTorch twin and
launch counters.

Counterpart of qb3_tpu/ops/pack_pallas.py's place_slabs: add W-word slabs
into a zeroed stream at sorted word bases.  Contributions touch disjoint
bits, so the sum equals their OR.  csrc/place.cu has two entries, each
with its own launch counter: place_slabs, the TPU kernel's function for
bases in any order (a zero fill, then one atomic add a slab word), and
place_parts, the stitch entry, one output-major pass over the parts of a
stitch, read where they lie.  In the port K6 is the device stitch
(stitch.stitch_words_device), which the strip encoder runs once per image;
it launches place_parts, and no path of the program calls place_slabs on
the card.  qb3_tpu calls its kernel only from the pack variant chosen by
QB3_PACK, which the port does not have.  A CPU tensor takes the twin and a
CUDA tensor launches the kernel; there is no fallback from one to the
other.
"""

from __future__ import annotations

import torch

from .. import _build
from .pack_cuda import on_cpu, require, stream_ptr

_K6 = _build.Kernel("qb3_place_slabs")
_K6_PARTS = _build.Kernel("qb3_place_parts")


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
    offsets (sorted on a stitch; the kernel does not need them sorted) ->
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


def place_parts(words, runs, n_out: int):
    """K6's stitch entry: the parts placed where the run table puts them, read
    where they lie on the card.  words: the parts, contiguous 1-D int32
    tensors on one CUDA device (a list, or the rows of an (S, NW) tensor);
    runs: the (6, R) int64 table of stitch.stitch_runs, one column a live
    part, its first row the part's index in words.  The table goes to the
    card in one copy from page-locked memory, its first row replaced by the
    parts' addresses -> (n_out,) int32, every word written once.  The CPU
    route (stitch_slabs, then place_slabs' twin) is stitch_words_device's."""
    dev = words[0].device
    if on_cpu(words[0]):
        raise ValueError("place_parts runs on a CUDA device; the CPU stitch takes the twin")
    table = torch.empty(runs.shape, dtype=torch.int64, pin_memory=True)
    host = table.numpy()
    host[1:] = runs[1:]
    for r, (s, nw) in enumerate(zip(runs[0].tolist(), runs[3].tolist())):
        p = words[s]
        require(p, torch.int32, f"part {s}", 1, dev)
        if p.shape[0] < nw:
            raise ValueError(f"part {s}: {p.shape[0]} words, its total needs {nw}")
        host[0, r] = p.data_ptr()
    out = torch.empty(n_out, dtype=torch.int32, device=dev)
    if n_out == 0:
        return out
    tab = table.to(dev, non_blocking=True)
    _K6_PARTS(tab.data_ptr(), runs.shape[1], out.data_ptr(), n_out, stream_ptr(dev))
    place_parts.launches += 1
    return out


place_slabs.launches = 0
place_parts.launches = 0
