"""Phase B: parallel variable-length bit packing.

PyTorch counterpart of qb3_tpu/ops/bitpack.py.  Replaces the serial oBits
writer (bitstream.h:66-126): every symbol's absolute bit position is the
exclusive prefix sum of the symbol lengths.  Contributions of different
symbols touch disjoint bits, so per-word sums equal the serial stream's ORs
exactly.

The stream is little-endian at bit level: bit position p lives in byte p>>3
at weight 1<<(p&7); uint32 words view as 4 little-endian bytes.

On a CUDA tensor the pack is the hand-written kernel K1
(pack_cuda.pack_groups_chunked); :func:`pack_groups` here is its plain twin.
The JAX package's pack variants chosen by environment (QB3_PACK, QB3_SEG) are
not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from .bitutils import M32, srl


def group_bits_bound(tbits: int, best: bool) -> int:
    """Static bound on one group's emitted bits (prefix + values [+ extras /
    CF header / index uniques])."""
    ubits = {8: 3, 16: 4, 32: 5, 64: 6}[tbits]
    if not best:
        return (ubits + 2) + 1 + 16 * (tbits + 2) + (16 if tbits == 64 else 0)
    return (ubits + 2) * 3 + 2 + (tbits + 2) + 16 * (tbits + 2) + \
        (16 if tbits == 64 else 0) + 8 * (tbits + 2)


def maxbits_bucket(max_glen: int, tbits: int, best: bool = False) -> int:
    """Tightened static pack bound from a stream's observed max group
    length, rounded up to 64 bits.  Exact for any stream whose groups stay
    within the bucket; re-encoding the SAME data is always safe."""
    return min(group_bits_bound(tbits, best), -(-int(max_glen) // 64) * 64)


def group_offsets(lens):
    """(..., ngroups, S) symbol lengths -> (glen, goff, total): per-group bit
    lengths, exclusive per-tile prefix sums (int64) and per-tile totals."""
    glen = lens.sum(-1, dtype=torch.int64)
    gend = torch.cumsum(glen, dim=-1)
    return glen, gend - glen, gend[..., -1]


def pack_groups(codes, lens, n_words: int, max_group_bits: int):
    """Two-level pack: dense per-group slab fold + one group-level scatter.

    codes (..., ngroups, S) int64 bit patterns, lens (..., ngroups, S) int;
    leading axes are independent tiles, each packed from bit 0 of its own
    n_words words.  Each group's symbols fold into a W-word slab at the
    group's bit phase (W from max_group_bits); the slab lands at word
    goff >> 5 with a scatter-add that drops words past n_words.  Returns
    (words (..., n_words) int32 u32 patterns, total bits (...) int64,
    glen (..., ngroups) int32).
    """
    *lead, ngroups, S = codes.shape
    glen, goff, total = group_offsets(lens)
    il = torch.cumsum(lens.to(torch.int64), dim=-1)
    bitpos = (goff & 31)[..., None] + il - lens
    W = (31 + max_group_bits + 31) // 32

    k = bitpos >> 5
    sh = bitpos & 31
    t = codes << sh
    lo = t & M32
    mid = srl(t, 32)
    hi = torch.where(sh == 0, 0, srl(codes, (64 - sh) & 63)) & M32
    slab = torch.stack([
        (torch.where(k == j, lo, 0) + torch.where(k == j - 1, mid, 0)
         + torch.where(k == j - 2, hi, 0)).sum(-1)
        for j in range(W)], dim=-1)  # (..., ngroups, W)

    widx = (goff >> 5)[..., None] + torch.arange(W, device=codes.device)
    live = widx < n_words
    ntiles = int(np.prod(lead, dtype=np.int64))
    tile = torch.arange(ntiles, device=codes.device).reshape(*lead, 1, 1)
    out = torch.zeros(ntiles * n_words, dtype=torch.int64, device=codes.device)
    out.index_add_(0, (tile * n_words + torch.where(live, widx, 0)).reshape(-1),
                   torch.where(live, slab, 0).reshape(-1))
    words = (out & M32).to(torch.int32).reshape(*lead, n_words)
    return words, total, glen.to(torch.int32)


def pack_groups_auto(codes, lens, n_words: int, max_group_bits: int):
    """The encoder's pack: the K1 wrapper launches the CUDA kernel for a
    CUDA tensor and takes :func:`pack_groups` for a CPU tensor."""
    from .pack_cuda import pack_groups_chunked

    return pack_groups_chunked(codes, lens, n_words, max_group_bits)


def words_to_bytes(words: np.ndarray, total_bits: int) -> bytes:
    """Host-side: uint32 words -> the byte stream (padded to a whole byte)."""
    nbytes = (int(total_bits) + 7) // 8
    raw = np.ascontiguousarray(words)
    if raw.dtype.byteorder == ">":
        raw = raw.byteswap()
    return raw.view(np.uint8)[:nbytes].tobytes()
