"""Dependency-light QB3 decoder: NumPy only, no kernel.

The counterpart of the reference's WASM client decoder (wasm/qb3decapi.cpp,
post.js): something a thin client can run anywhere to read QB3 streams
produced by this engine or the reference, using the same parallel wavefront
design as the device path but on NumPy vector ops.

qb3_tpu/lite.py with its imports pointed at the port: the original imports
qb3_tpu.api, which loads JAX; this copy imports only qb3_tpu_torch modules
(their helpers import torch, but the decode runs on NumPy alone).

    from qb3_tpu_torch import lite
    img, info = lite.decode(stream_bytes)
"""

from __future__ import annotations

import numpy as np

from . import container, rle, tables as T
from .api import NP_FROM_DT, UNSIGNED, dequantize, unpack_small, walk_offsets
from .constants import B, B2, HILBERT, DType, Mode, curve_offsets, needs_rle
from .offsets import KIND_BITS, KIND_CF, KIND_CF0, KIND_IDX, KIND_NORMAL

_DEC_GROUP = T.DEC_GROUP
_DEC_SINGLE = T.DEC_SINGLE
_IDX_DEC = T.IDX_DEC


def _peek64(words, pos):
    widx = (pos >> 6).astype(np.int64)
    sh = (pos & 63).astype(np.uint64)
    w0 = words[widx]
    w1 = words[widx + 1]
    hi = np.where(sh == 0, np.uint64(0), w1 << ((np.uint64(64) - sh) & np.uint64(63)))
    return (w0 >> sh) | hi


def _dec_value(w, rung, single):
    tr = np.clip(rung, 0, 7)
    ti = (w & ((np.uint64(1) << (tr + 2).astype(np.uint64)) - np.uint64(1))).astype(np.int64)
    tbl = _DEC_SINGLE if single else _DEC_GROUP
    tl = tbl[tr, ti, 0].astype(np.int64)
    tv = tbl[tr, ti, 1].astype(np.uint64)
    r64 = np.clip(rung, 2, None).astype(np.uint64)
    rbit = np.uint64(1) << r64
    short = (w & np.uint64(1)) == 0
    n = (w >> np.uint64(1)) & np.uint64(1)
    v2 = (w >> np.uint64(2)) & (rbit - np.uint64(1))
    cl = np.where(short, rung, rung + 1 + n.astype(np.int64))
    cv = np.where(short, (w & (rbit - np.uint64(1))) >> np.uint64(1),
                  np.where(n == 0, v2 | (rbit >> np.uint64(1)), v2 | rbit))
    use_tbl = rung <= 7
    return np.where(use_tbl, tv, cv), np.where(use_tbl, tl, cl)


def _magsabs(v):
    return (v >> np.uint64(1)) + (v & np.uint64(1))


def _decode_groups(words, kind, val_pos, vrung, cf, apply_step):
    n = kind.shape[0]
    pos = val_pos.astype(np.int64)
    is_bits = kind == KIND_BITS
    is_cf0 = kind == KIND_CF0
    is_idx = kind == KIND_IDX
    is_group = (kind == KIND_NORMAL) | (kind == KIND_CF)
    onebit = is_bits | is_cf0
    g = np.zeros((n, B2), np.uint64)
    for i in range(B2):
        w = _peek64(words, pos)
        gv, gl = _dec_value(w, vrung, False)
        ovf = is_group & (gl == 65)
        extra = _peek64(words, pos + 64) & np.uint64(1)
        gv = gv | np.where(ovf, extra << np.uint64(62), np.uint64(0))
        il = _IDX_DEC[(w & np.uint64(15)).astype(np.int64), 0].astype(np.int64)
        iv = _IDX_DEC[(w & np.uint64(15)).astype(np.int64), 1].astype(np.uint64)
        g[:, i] = np.where(is_group, gv, np.where(is_idx, iv,
                  np.where(onebit, w & np.uint64(1), np.uint64(0))))
        pos = pos + np.where(is_group, gl, np.where(is_idx, il,
                             np.where(onebit, 1, 0)))
    if is_idx.any():
        maxidx = np.max(np.where(is_idx[:, None], g, 0), axis=1).astype(np.int64)
        uq = np.zeros((n, B2 // 2), np.uint64)
        for u in range(B2 // 2):
            live = is_idx & (u <= maxidx)
            w = _peek64(words, pos)
            uv, ul = _dec_value(w, vrung, True)
            uq[:, u] = np.where(live, uv, np.uint64(0))
            pos = pos + np.where(live, ul, 0)
        gi = np.take_along_axis(uq, np.clip(g, 0, 7).astype(np.int64), axis=1)
        g = np.where(is_idx[:, None], gi, g)
    # step restore
    restore = is_group if apply_step else (kind == KIND_CF)
    rb = ((g >> vrung[:, None].astype(np.uint64)) & np.uint64(1)).astype(np.uint32)
    acc = (rb << np.arange(B2, dtype=np.uint32)).sum(axis=1, dtype=np.uint32)
    match = (acc & (acc + 1)) == 0
    ones = np.where(acc == 0, 0, np.uint64(np.floor(np.log2(acc | np.uint32(1)))).astype(np.int64) + 1)
    do = restore & match & (vrung >= 1) & (ones < B2)
    lane = np.arange(B2)
    flip = do[:, None] & (lane[None, :] == ones[:, None])
    g ^= np.where(flip, np.uint64(1), np.uint64(0)) << vrung[:, None].astype(np.uint64)
    # CF multiply-back
    if (kind == KIND_CF).any() or is_cf0.any():
        cfv = cf.astype(np.uint64)
        mm = _magsabs(g) * (cfv[:, None] << np.uint64(1)) - (g & np.uint64(1))
        g = np.where((kind == KIND_CF)[:, None], mm, g)
        neg = ((cfv - np.uint64(1)) << np.uint64(1)) | np.uint64(1)
        g = np.where(is_cf0[:, None], np.where(g != 0, neg[:, None], np.uint64(0)), g)
    return g


def _reconstruct(g, h, w, nbands, order, cband, out_dtype):
    tbits = np.iinfo(out_dtype).bits
    nblocks = g.shape[0] // nbands
    gg = g.reshape(nblocks, nbands, B2)
    seq = ((gg >> np.uint64(1)) ^ (np.uint64(0) - (gg & np.uint64(1))))
    seq = seq.transpose(1, 0, 2).reshape(nbands, -1)
    if tbits < 64:
        seq = seq & np.uint64((1 << tbits) - 1)
    vals = np.cumsum(seq, axis=1, dtype=np.uint64).reshape(nbands, nblocks, B2).astype(out_dtype)
    offs = curve_offsets(order)
    lane_of = np.zeros((B, B), np.int64)
    for i, (dy, dx) in enumerate(offs):
        lane_of[dy, dx] = i
    ys = np.arange((h + B - 1) // B) * B
    xs = np.arange((w + B - 1) // B) * B
    ys[-1] = h - B
    xs[-1] = w - B
    nby, nbx = len(ys), len(xs)
    py, px = np.arange(h), np.arange(w)
    by = np.where(py >= ys[-1], nby - 1, np.minimum(py // B, nby - 1))
    bx = np.where(px >= xs[-1], nbx - 1, np.minimum(px // B, nbx - 1))
    lane = lane_of[py[:, None] - ys[by][:, None], px[None, :] - xs[bx][None, :]]
    bidx = by[:, None] * nbx + bx[None, :]
    img = vals[:, bidx, lane].transpose(1, 2, 0)
    cb = np.asarray(cband)
    add = (cb != np.arange(nbands)).astype(out_dtype)
    return (img + img[:, :, cb] * add[None, None, :]).astype(out_dtype)


def decode(stream: bytes):
    """Decode a QB3 stream -> ((H, W, C) array, StreamInfo). NumPy only."""
    info = container.parse_headers(stream)
    np_dt = NP_FROM_DT[DType(info.dtype)]
    uns_dt = UNSIGNED[np.dtype(np_dt).itemsize]
    data = stream[info.data_offset:]
    h, w, nb = info.ysize, info.xsize, info.nbands
    if info.mode == Mode.STORED:
        out = np.frombuffer(data, dtype=np_dt).reshape(h, w, nb).copy()
        return out, info
    if needs_rle(info.mode):
        data = rle.rle0_decode(data, rle.rle0_decoded_size(data))
    dh, dw = h, w
    if w < B or h < B:
        ngroups = (h * w + B2 - 1) // B2
        dw, dh = (B, ngroups * B) if w < B else (ngroups * B, B)
    nblocks = ((dh + B - 1) // B) * ((dw + B - 1) // B)
    # the C++ walk where its library builds, else the Python one
    meta, _ = walk_offsets(data, nblocks, nb, np.dtype(uns_dt).itemsize, info.mode)
    # generous tail padding: numpy gathers do not clamp like XLA's do, and
    # the wavefront peeks up to ~128 bits past the final code
    words = np.zeros(((len(data) + 7) // 8 + 4) * 8, np.uint8)
    words[: len(data)] = np.frombuffer(data, np.uint8)
    words = words.view("<u8")
    g = _decode_groups(words, meta["kind"].reshape(-1),
                       meta["val_pos"].reshape(-1), meta["vrung"].reshape(-1),
                       meta["cf"].reshape(-1), info.mode != Mode.FTL)
    uns = _reconstruct(g, dh, dw, nb, info.order or HILBERT, info.cband, uns_dt)
    if (dh, dw) != (h, w):
        uns = unpack_small(uns, h, w, nb)
    out = uns.view(np_dt)
    if info.quanta > 1:
        out = dequantize(out, info.quanta)
    return out, info
