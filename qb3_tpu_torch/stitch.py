"""Bit-granularity stream concatenation: on the host with NumPy, and on the
device through K6.

QB3 payloads are bit-dense: appending one sub-stream after another lands at
arbitrary bit phase.  stitch_words, stitch_bytes and assemble_scatter are
copies of qb3_tpu/stitch.py's host functions; stitch_words_device is the
counterpart of its device stitch, on torch tensors, with the placement done
by K6's stitch entry (ops/place_cuda.place_parts) on the card and by the
slab cut and K6's twin on the CPU; scatter_stitch_shard is the
counterpart of its in-shard stitch, run by each shard of a
parallel/sharded.ShardGroup.  reference analog: the shared oBits
accumulator across sub-encodes (QB3encode.cpp:405-455).
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.bitutils import M32, srl, words_u64
from .ops.pack_cuda import on_cpu
from .ops.place_cuda import place_parts, place_slabs

STITCH_W = 32  # words per slab of the CPU route (stitch_slabs)


def _as_u64(words: np.ndarray, nbits: int) -> np.ndarray:
    """View any word array as little-endian u64 words, masked to nbits."""
    b = np.ascontiguousarray(words).view(np.uint8)
    nbytes = (nbits + 7) // 8
    nw = (nbits + 63) // 64
    buf = np.zeros(nw * 8, np.uint8)
    buf[:nbytes] = b[:nbytes]
    w = buf.view("<u8").copy()
    tail = nbits & 63
    if nw and tail:
        w[-1] &= np.uint64((1 << tail) - 1)
    return w


def stitch_words(parts) -> tuple[np.ndarray, int]:
    """parts: iterable of (words_array, nbits) -> (u64 words, total_bits).

    Bits of part k start at sum(nbits of parts < k); unused tail bits of the
    result are zero.
    """
    parts = [(w, int(n)) for w, n in parts]
    total = sum(n for _, n in parts)
    out = np.zeros(total // 64 + 2, np.uint64)
    off = 0
    for words, nbits in parts:
        if nbits == 0:
            continue
        w = _as_u64(words, nbits)
        base, s = off >> 6, off & 63
        nw = w.shape[0]
        if s == 0:
            out[base : base + nw] |= w
        else:
            s64 = np.uint64(s)
            out[base : base + nw] |= w << s64
            out[base + 1 : base + nw + 1] |= w >> np.uint64(64 - s)
        off += nbits
    return out, total


def stitch_bytes(parts) -> bytes:
    """stitch_words, returned as the payload byte string."""
    words, total = stitch_words(parts)
    return words.view(np.uint8)[: (total + 7) // 8].tobytes()


def scatter_stitch_shard(words32, nbits, group):
    """The pod-shape stitch, run by each shard of a ShardGroup
    (parallel/sharded.py): the shard phase-shifts its packed bits to the
    global bit offset and keeps its OWN word span; the only data between
    shards is the all-gather of the per-shard bit totals (8 B each).
    Counterpart of qb3_tpu's scatter_stitch_shard, which runs inside
    shard_map; the shift runs in plain PyTorch, as qb3_tpu runs it in XLA.

    words32: (NW32,) int32 local packed stream (bits past nbits garbage);
    nbits: local bit count (a scalar tensor).  Returns (own (NW64 + 1,)
    int64 u64 words, n_own, nbits): global words base..base + n_own, where
    own[n_own] is the partial boundary word shared with the NEXT shard's
    word 0 (assemble_scatter ORs the overlap on the host; doing it on the
    device would need a serial carry chain that breaks when a shard owns
    zero words)."""
    nw32 = words32.shape[0]
    nw64 = (nw32 + 1) // 2
    w = words_u64(torch.cat([words32, words32.new_zeros(nw32 % 2)]))
    nbits = nbits.reshape(()).to(torch.int64)
    all_tot = group.all_gather(nbits)
    S, my = group.axis_size(), group.axis_index()
    off = torch.where(torch.arange(S, device=all_tot.device) < my, all_tot, 0).sum()
    end = off + nbits
    base = off >> 6
    # non-last shards do not own their partial tail word (the next shard's
    # region starts inside it); the last shard owns through the end
    n_own = (((end + 63) >> 6 if my == S - 1 else end >> 6) - base).to(torch.int32)

    nwords = (nbits + 63) >> 6
    lane = torch.arange(nw64, device=w.device)
    tail = nbits & 63
    tmask = torch.where(tail == 0, -1, (1 << tail) - 1)
    w = torch.where(lane < nwords - 1, w, torch.where(lane == nwords - 1, w & tmask, 0))
    sh = off & 63
    back = (64 - sh) & 63  # the right shift of the carried-over bits (sh != 0)
    lo = w << sh
    prevw = torch.cat([w.new_zeros(1), w[:-1]])
    hi = torch.where(sh == 0, 0, srl(prevw, back))
    spill = torch.where(sh == 0, 0, srl(w[-1], back))
    return torch.cat([lo | hi, spill[None]]), n_own, nbits


def assemble_scatter(owns, n_owns, totals: np.ndarray) -> bytes:
    """Host assembly of scatter_stitch_shard outputs: word-aligned
    concatenation; consecutive shards share one boundary word, whose
    disjoint-bit halves combine with an OR (so shards owning zero whole
    words — tiny/highly-compressible strips — just OR their bits into the
    shared word instead of corrupting the chain).  owns: each shard's u64
    words (rows of an array, or a list holding at least n_own + 1 each)."""
    total = int(totals.sum())
    out = np.zeros(total // 64 + 2, np.uint64)
    offs = np.cumsum(totals) - totals
    for s in range(len(owns)):
        base = int(offs[s]) >> 6
        n = int(n_owns[s])
        out[base : base + n + 1] |= owns[s][: n + 1]
    return out.view(np.uint8)[: (total + 7) // 8].tobytes()


def stitch_runs(totals) -> np.ndarray:
    """The run table of K6's stitch entry, pointers aside: one column a part
    with bits (totals[s] > 0), in stream order -> (6, R) int64 rows: the
    part's index, its output word base (bit offset >> 5), its end word (one
    past the last word it touches, ceil((offset + total) / 32)), its source
    words (ceil(total / 32)), its shift (offset & 31) and its last source
    word's mask (the bits below total & 31, all where that is 0).  Both the
    bases and the ends are non-decreasing."""
    t = np.asarray([int(n) for n in totals], np.int64)
    off = np.cumsum(t) - t
    live = np.flatnonzero(t > 0)
    n, o = t[live], off[live]
    tail = n & 31
    return np.stack([live, o >> 5, (o + n + 31) >> 5, (n + 31) >> 5, o & 31,
                     np.where(tail == 0, M32, (1 << tail) - 1)]).astype(np.int64).reshape(6, -1)


def stitch_slabs(words, totals):
    """The slabs of a device stitch: each part masked past its total and
    funnel-shifted to its bit phase, its shifted span cut into W-word slabs
    at word bases (off >> 5) + k*W, sorted because the parts are in order
    -> (slab (nslabs, W) int32, base (nslabs,) int32), W = STITCH_W, or
    None where every part is empty.  words and totals as
    stitch_words_device takes them."""
    W = STITCH_W
    totals = [int(t) for t in totals]
    dev = words[0].device
    offs = np.cumsum([0] + totals[:-1], dtype=np.int64)
    live = [s for s, n in enumerate(totals) if n > 0]
    if not live:
        return None
    n = np.array([totals[s] for s in live], np.int64)
    off = offs[live]
    nw = (n + 31) >> 5  # source words of each part
    sh = off & 31
    nslab = -(-((sh + n + 31) >> 5) // W)  # slabs of each part's shifted span
    start = np.cumsum(nw) - nw  # each part's first word in the joined parts
    # the joined parts, each masked past its total (its last word's tail)
    cat = torch.cat([words[s][: int(k)] for s, k in zip(live, nw)]).to(torch.int64) & M32
    tail = n & 31
    last = torch.from_numpy(start + nw - 1).to(dev)
    cat[last] &= torch.from_numpy(np.where(tail == 0, M32, (1 << tail) - 1)).to(dev)
    # one row per slab: its first source word, the part's words left from
    # there, whether it is the part's first slab, the phase and the base
    part = np.repeat(np.arange(len(live)), nslab)
    k = np.arange(part.size) - np.repeat(np.cumsum(nslab) - nslab, nslab)
    rows = np.stack([start[part] + k * W, nw[part] - k * W, k == 0, sh[part],
                     (off[part] >> 5) + k * W])
    q0, left, first, s, base = torch.from_numpy(rows).to(dev)
    j = torch.arange(W, device=dev)
    src = q0[:, None] + j
    cur_ok = j < left[:, None]
    prev_ok = (j - 1 < left[:, None]) & ~((j == 0) & (first[:, None] == 1))
    cur = torch.where(cur_ok, cat[torch.where(cur_ok, src, 0)], 0)
    prev = torch.where(prev_ok, cat[torch.where(prev_ok, src - 1, 0)], 0)
    s = s[:, None]
    slab = ((cur << s) & M32) | torch.where(s == 0, 0, prev >> ((32 - s) & 31))
    return slab.to(torch.int32), base.to(torch.int32)


def stitch_words_device(words, totals, n_out: int):
    """Device stitch: per-part u32 words -> one bit-dense stream, through K6.

    words: the parts' int32 word tensors on one device, in stream order (a
    list of 1-D tensors of any lengths, or the rows of an (S, NW) tensor),
    each holding at least ceil(totals[s] / 32) words, bits past totals[s]
    unspecified; totals: the parts' bit lengths (host integers); n_out: the
    output's u32 word count (words past it are dropped, words past the
    total are zero; ceil(sum / 32) keeps every bit).  On the card K6's
    stitch entry places every part at its bit offset in one launch
    (place_parts, the runs of stitch_runs); on the CPU, stitch_slabs cuts
    the parts into slabs and K6's twin adds them into a zeroed stream (the
    parts touch disjoint bits).  Returns ((n_out,) int32 words; total
    bits).  qb3_tpu's stitch_words_device returns the same stream as u64
    words.
    """
    total = sum(int(t) for t in totals)
    if not on_cpu(words[0]):
        return place_parts(words, stitch_runs(totals), n_out), total
    cut = stitch_slabs(words, totals)
    if cut is None:
        return torch.zeros(n_out, dtype=torch.int32, device=words[0].device), total
    return place_slabs(*cut, n_out), total
