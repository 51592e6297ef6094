"""Batched multi-tile encode/decode: many same-shape rasters per dispatch.

PyTorch counterpart of the "ic" and "ix" paths of qb3_tpu/batch.py.  One
pass of phase A and one K1 launch encode the whole batch; decode is one
K3 + K2 walk ("ic") or one K4 walk ("ix") over the flat tile layout, then
one reconstruct.  Each tile is an independent QB3 stream (fresh band
state), identical to encoding it alone.
"""

from __future__ import annotations

import numpy as np
import torch

from . import container
from .api import (DT_FROM_NP, NP_FROM_DT, UNSIGNED, _fused_ix_params, default_cband,
                  fast_encode, from_carrier, ic_inputs, not_ported, stream_words,
                  to_carrier)
from .constants import B, B2, HILBERT, ZCURVE, DType, Mode
from .errors import QB3ShapeError
from .ops.bitpack import words_to_bytes
from .ops.decode import decode_indexed_narrow, payload_words, reconstruct_batch
from .ops.decode_chunked import IC_DEFAULT_K, decode_chunked_auto, pack_ic, parse_ic


def _flat_tile_layout(wlists):
    """Concatenate per-tile u64 payload words at a fixed 64-word-aligned
    stride -> (flat words (n, tw64) u64, tile stride in u32 words)."""
    tw64 = max(len(x) for x in wlists) + 2
    tw64 = -(-tw64 // 64) * 64  # whole 128-word rows per tile
    flat = np.zeros((len(wlists), tw64), np.uint64)
    for j, x in enumerate(wlists):
        flat[j, : len(x)] = x
    return flat, tw64 * 2


def encode_tiles(imgs: np.ndarray, mode: int = Mode.FTL, coreband=None,
                 index=False, device="cuda") -> list[bytes]:
    """Encode (N, H, W, C) same-shape tiles in one dispatch -> N streams.

    FTL/BASE, with no sidecar, the "ic" sidecar or (index True / "ix") the
    "ix" sidecar; each tile's stream is byte-identical to a standalone
    encode.
    """
    if imgs.ndim != 4:
        raise QB3ShapeError("expected (N, H, W, C) tiles")
    n, h, w, nb = imgs.shape
    if mode in (Mode.CF_H, Mode.CF):
        raise not_ported("best")
    if mode not in (Mode.FTL, Mode.BASE_H, Mode.BASE_Z) or h < B or w < B:
        raise QB3ShapeError("batch encode supports FTL/BASE tiles >= 4x4")
    dt = DT_FROM_NP[imgs.dtype]
    cband = tuple(coreband) if coreband is not None else tuple(default_cband(nb))
    zorder = mode == Mode.BASE_Z
    size = imgs.dtype.itemsize
    uns = imgs.view(UNSIGNED[size])
    n_words = stream_words(w, h, nb, dt)
    dev = torch.device(device)
    zero = torch.zeros(n, nb, dtype=torch.int64, device=dev)
    words, totals, _, _, glen, rung = fast_encode(
        to_carrier(uns, dev), zero, zero, ZCURVE if zorder else HILBERT, cband,
        mode == Mode.FTL, 8 * size, n_words, lanewise=True)
    if index == "ic":
        # sidecar pieces on the device (chunk_spans' arithmetic), so only
        # spans and entry rungs cross to the host
        k = IC_DEFAULT_K
        nblocks = glen.shape[1] // nb
        nchunks = -(-nblocks // k)
        g = torch.zeros(n, nchunks * k * nb, dtype=torch.int64, device=dev)
        g[:, : nblocks * nb] = glen
        spans = g.reshape(n, nchunks, -1).sum(-1).cpu().numpy()
        entry = torch.cat([torch.zeros_like(rung[:, :1]),
                           rung[:, k - 1 : (nchunks - 1) * k : k]], dim=1).cpu().numpy()
    elif index:
        glens = glen.cpu().numpy()
    totals = totals.cpu().numpy()
    used = int(totals.max() + 31) // 32
    words = words[:, :used].cpu().numpy().view(np.uint32)
    out = []
    for i in range(n):
        idx, sig = None, b"ix"
        if index == "ic":
            if int(spans[i].sum()) < 1 << 31:
                idx, sig = pack_ic(spans[i], entry[i], k), b"ic"
        elif index:
            idx = glens[i].astype("<u2").tobytes()
        hdr = container.write_headers(w, h, nb, dt, mode, list(cband), 1,
                                      ZCURVE if zorder else 0, idx, sig)
        out.append(hdr + words_to_bytes(words[i], int(totals[i])))
    return out


def decode_tiles(streams: list[bytes], device="cuda") -> np.ndarray:
    """Decode N same-shape FTL/BASE streams with the "ic" or the "ix"
    sidecar in one dispatch -> (N, H, W, C)."""
    infos = [container.parse_headers(s) for s in streams]
    i0 = infos[0]
    if any((i.xsize, i.ysize, i.nbands, i.dtype, i.mode) !=
           (i0.xsize, i0.ysize, i0.nbands, i0.dtype, i0.mode) for i in infos):
        raise QB3ShapeError("batch decode requires same-shape streams")
    if all(i.index_best is not None for i in infos):
        raise not_ported("best")
    chunked = all(i.index_chunked is not None for i in infos)
    if not chunked and any(i.index is None for i in infos):
        raise QB3ShapeError("batch decode needs the ix, ic or ib sidecar")
    h, w, nb = i0.ysize, i0.xsize, i0.nbands
    if h % B != 0 or w % B != 0:
        raise QB3ShapeError("batch decode requires 4-aligned tiles")
    np_dt = NP_FROM_DT[DType(i0.dtype)]
    size = np.dtype(np_dt).itemsize
    tbits = 8 * size
    nblocks = (h // B) * (w // B)
    order = i0.order or HILBERT
    apply_step = i0.mode != Mode.FTL
    dev = torch.device(device)

    wlists = [payload_words(s[i.data_offset:]) for s, i in zip(streams, infos)]
    flat, tile_words32 = _flat_tile_layout(wlists)
    if flat.size * 64 >= 1 << 31:
        # the flat walk carries int32 bit cursors
        raise QB3ShapeError(
            "batch exceeds the 2^31-bit flat-decode limit; split the batch")
    n = len(streams)
    if chunked:
        metas = [parse_ic(i.index_chunked, nblocks, nb) for i in infos]
        if any(m is None for m in metas) or any(m[0] != metas[0][0] for m in metas):
            raise QB3ShapeError("inconsistent ic sidecar")
        inp = ic_inputs(flat, metas, tile_words32, tbits, dev)
        k = inp["k"]
        nchunks_per = -(-nblocks // k)
        g = decode_chunked_auto(inp["words32"], inp["starts"], inp["entry"], k,
                                n * nchunks_per * k, nb, apply_step, tbits,
                                inp["maxw"], inp["R"])
        g = g.reshape(n, nchunks_per * k, nb, B2)[:, :nblocks]
    else:
        glens = [np.frombuffer(i.index, dtype="<u2") for i in infos]
        if any(x.size != nblocks * nb for x in glens):
            raise QB3ShapeError("inconsistent ix sidecar")
        glens = np.stack(glens).astype(np.int32)
        nreg, R = _fused_ix_params(glens, tbits, tile_words32)
        words32 = torch.from_numpy(flat.reshape(-1).view(np.int32)).to(dev)
        g = decode_indexed_narrow(words32, torch.from_numpy(glens).to(dev), nblocks, nb,
                                  apply_step, tbits, n, tile_words32, nreg, fused=R)
        g = g.reshape(n, nblocks, nb, B2)
    img = reconstruct_batch(g, h, w, nb, order, tuple(i0.cband), tbits)
    return from_carrier(img, size).view(np_dt)
