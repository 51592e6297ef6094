"""Value decoding primitives and image reconstruction.

PyTorch counterpart of the reconstruct half of qb3_tpu/ops/decode.py: the
arithmetic codeswitch and group-VLC decoders the chunk walk uses, and the
step from decoded mag-sign groups to the image — the per-band prefix-sum
un-delta (QB3decode.h:717-722), the inverse scan, and the band-delta add
pass (QB3decode.h:729-737).  Values ride in int64 carriers (bitutils.py);
int64 sums wrap like uint64, so the un-delta needs none of the JAX
package's u32 plane splitting.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import B, B2, curve_offsets
from .bitutils import smag, srl, wrap
from .encode import block_origins


def payload_words(payload: bytes) -> np.ndarray:
    """Payload bytes -> little-endian uint64 words with a spill word."""
    n = (len(payload) + 7) // 8 + 1
    buf = np.zeros(n * 8, dtype=np.uint8)
    buf[: len(payload)] = np.frombuffer(payload, np.uint8)
    return buf.view("<u8")


def dsw_arith(w1, ubits: int):
    """Arithmetic codeswitch decode == the DSW table (tables._make_dsw).

    w1: int64 stream bits AFTER the change flag.  Returns (cs_len incl flag,
    delta), valid where the flag was 1.
    """
    r = ubits - 1  # plain VLC rung of the codeswitch code
    rbit = 1 << r
    vmask = rbit - 1
    short = (w1 & 1) == 0
    n = (w1 >> 1) & 1
    v2 = srl(w1, 2) & vmask
    v = torch.where(short, (w1 & vmask) >> 1,
                    torch.where(n == 0, v2 | (rbit >> 1), v2 | rbit))
    ln = torch.where(short, r, r + 1 + n) + 1
    mag = v >> 1
    neg = (v & 1) == 1
    delta = torch.where(neg, (-(mag + 1)) & ((1 << ubits) - 1),
                        (mag + 1) & ((1 << (ubits - 1)) - 1))
    return ln, delta


def _vlc_decode_arith(w, rung):
    """Arithmetic group-context VLC decode: base 3-range code + value swap.

    The decode tables are the inverse of (swap o vlc); the swap is an
    involution, so decode == swap(vlc_decode(bits)).  Valid for rung >= 1;
    the rung-0 class never reaches here.  w: int64 stream bits (the low
    rung+2 matter); returns (value, length).
    """
    r = rung.clamp(min=1)
    rbit = 1 << r
    vmask = rbit - 1
    short = (w & 1) == 0
    n = (w >> 1) & 1
    v2 = srl(w, 2) & vmask
    v = torch.where(short, srl(w & vmask, 1),
                    torch.where(n == 0, v2 | srl(rbit, 1), v2 | rbit))
    ln = torch.where(short, r, r + 1 + n)
    # group-context swap (rung 1: 1<->2, rung 2: 3<->4, 3..7: 2^r-1<->2^r)
    a = torch.where(r == 1, 1, torch.where(r == 2, 3, (1 << r.clamp(max=7)) - 1))
    do_swap = r <= 7
    v = torch.where(do_swap & (v == a), a + 1,
                    torch.where(do_swap & (v == a + 1), a, v))
    return v, ln


def _undelta_cumsum_blocks(s):
    """Hierarchical scan-order prefix sum of deltas, block-major.

    s: (..., nblocks, C, B2) int64.  The scan sequence per band is
    blocks-major-then-lanes; the prefix decomposes into an in-lane cumsum
    plus a block-level carry chain, all in the native layout.  int64 sums
    wrap, so the result is exact mod 2^64 and, masked, mod 2^tbits.
    """
    cl = torch.cumsum(s, dim=-1)
    tl = cl[..., B2 - 1]  # (..., nblocks, C) block totals
    ctl = torch.cumsum(tl, dim=-2)
    carry = torch.cat([torch.zeros_like(ctl[..., :1, :]), ctl[..., :-1, :]], dim=-2)
    return cl + carry[..., None]


def _lane_of(order: int) -> np.ndarray:
    """(B, B) lane index of each in-block raster position along the curve."""
    lane_of = np.zeros((B, B), dtype=np.int64)
    for i, (dy, dx) in enumerate(curve_offsets(order)):
        lane_of[dy, dx] = i
    return lane_of


def _band_add(img, cband, tbits: int):
    """Band-delta add pass (QB3decode.h:729-737) on (..., C) images."""
    nb = img.shape[-1]
    cb = np.asarray(cband)
    core = img[..., torch.as_tensor(cb, device=img.device)]
    dep = torch.as_tensor(cb != np.arange(nb), device=img.device).to(torch.int64)
    return wrap(img + core * dep, tbits)


def reconstruct_batch(groups, h: int, w: int, nbands: int, order: int,
                      cband: tuple[int, ...], tbits: int):
    """Flat multi-tile reconstruct: (ntiles, nblocks, C, B2) mag-sign groups
    -> (ntiles, H, W, C) int64 images, 4-aligned tiles, fresh band state per
    tile."""
    if h % B or w % B:
        raise ValueError("batch reconstruct requires 4-aligned tiles")
    ntiles = groups.shape[0]
    v = wrap(_undelta_cumsum_blocks(smag(groups, tbits)), tbits)
    inv = torch.as_tensor(_lane_of(order).reshape(-1), device=groups.device)
    t = v[..., inv].reshape(ntiles, h // B, w // B, nbands, B, B)
    img = t.permute(0, 1, 4, 2, 5, 3).reshape(ntiles, h, w, nbands)
    return _band_add(img, cband, tbits)


def reconstruct(groups, entry_prev, h: int, w: int, nbands: int, order: int,
                cband: tuple[int, ...], tbits: int):
    """Mag-sign groups (nblocks, C, B2) -> ((H, W, C) int64 image, exit_prev).

    Prefix-sum un-delta in scan order, inverse scan gather (later blocks win
    on the overlapped edge pixels, matching the serial write order), then the
    band-delta add pass.
    """
    v = _undelta_cumsum_blocks(smag(groups, tbits))
    v = wrap(v + entry_prev[None, :, None], tbits)
    exit_prev = v[-1, :, B2 - 1]
    lane_of = _lane_of(order)
    if h % B == 0 and w % B == 0:
        # aligned: static inverse curve permutation + layout transposes
        inv = torch.as_tensor(lane_of.reshape(-1), device=groups.device)
        t = v[:, :, inv].reshape(h // B, w // B, nbands, B, B)
        img = t.permute(0, 3, 1, 4, 2).reshape(h, w, nbands)
    else:
        ys = block_origins(h)
        xs = block_origins(w)
        nby, nbx = len(ys), len(xs)
        # pixel -> providing block (the last block in scan order wins on overlap)
        py = np.arange(h)
        px = np.arange(w)
        by = np.where(py >= ys[-1], nby - 1, np.minimum(py // B, nby - 1))
        bx = np.where(px >= xs[-1], nbx - 1, np.minimum(px // B, nbx - 1))
        lane = lane_of[(py[:, None] - ys[by][:, None]), (px[None, :] - xs[bx][None, :])]
        src = (by[:, None] * nbx + bx[None, :]) * B2 + lane  # (h, w) into (nblocks*B2)
        flat = v.transpose(0, 1).reshape(nbands, -1)  # (C, nblocks*B2)
        img = flat[:, torch.as_tensor(src.reshape(-1), device=groups.device)]
        img = img.reshape(nbands, h, w).permute(1, 2, 0)
    return _band_add(img, cband, tbits), exit_prev
