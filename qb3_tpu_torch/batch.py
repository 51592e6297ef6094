"""Batched multi-tile encode/decode: many same-shape rasters per dispatch.

PyTorch counterpart of qb3_tpu/batch.py.  One K1 launch packs the whole
batch, after one pass of phase A (FTL / BASE) or one pass of the best
modes' phase A for each group of tiles (BEST_GROUPS groups at most a pass:
its index trial's intermediates grow with the batch); decode is one K3 + K2
walk ("ic"), one K4 walk ("ix") or one K7 + K5 pass ("ib", best modes) over
the flat tile layout, then one reconstruct.  Each tile is an independent
QB3 stream (fresh band state), identical to encoding it alone.
"""

from __future__ import annotations

import numpy as np
import torch

from . import container
from .api import (DT_FROM_NP, NP_FROM_DT, UNSIGNED, _fused_ix_params, _parse_best_sidecar,
                  best_sidecar, default_cband, fast_encode, from_carrier, ic_inputs,
                  stream_words, to_carrier, walk_inputs)
from .constants import B, B2, HILBERT, ZCURVE, DType, Mode
from .errors import QB3ShapeError
from .ops.bitpack import group_bits_bound, pack_groups_auto, words_to_bytes
from .ops.decode import decode_groups, decode_indexed_narrow, payload_words, reconstruct_batch
from .ops.decode_chunked import IC_DEFAULT_K, decode_chunked_auto, pack_ic, parse_ic
from .ops.encode_best import encode_best_blocks

# groups (blocks x bands) the best modes' phase A takes in one pass: about
# 21 u8 512x512x3 tiles, ~6 GiB of the index trial's intermediates
BEST_GROUPS = 1 << 20


def _flat_tile_layout(wlists):
    """Concatenate per-tile u64 payload words at a fixed 64-word-aligned
    stride -> (flat words (n, tw64) u64, tile stride in u32 words)."""
    tw64 = max(len(x) for x in wlists) + 2
    tw64 = -(-tw64 // 64) * 64  # whole 128-word rows per tile
    flat = np.zeros((len(wlists), tw64), np.uint64)
    for j, x in enumerate(wlists):
        flat[j, : len(x)] = x
    return flat, tw64 * 2


def best_encode_tiles(uns: np.ndarray, order: int, cband: tuple, n_words: int, device):
    """The best modes' batch encode (qb3_tpu's _batch_best_kernel): phase A
    for each group of whole tiles of at most BEST_GROUPS groups (one tile
    when a tile has more), into one (N, ngroups, S) symbol buffer, then one
    K1 launch -> (words, totals, glen, meta16, cfv).  A tile's symbols are
    the same whatever group it is in."""
    n, h, w, nb = uns.shape
    tbits = 8 * uns.dtype.itemsize
    per = max(1, BEST_GROUPS // (((h + B - 1) // B) * ((w + B - 1) // B) * nb))
    codes = lens = meta16 = cfv = None
    for t0 in range(0, n, per):
        x = to_carrier(uns[t0:t0 + per], device)
        zero = torch.zeros(x.shape[0], nb, dtype=torch.int64, device=device)
        c, ln, _, _, _, m16, cf, _, _ = encode_best_blocks(x, zero, zero, zero, order, cband,
                                                           tbits)
        if codes is None:
            codes = c.new_empty((n, *c.shape[1:]))
            lens = ln.new_empty((n, *ln.shape[1:]))
            meta16 = m16.new_empty((n, *m16.shape[1:]))
            cfv = cf.new_empty((n, *cf.shape[1:]))
        for out, part in ((codes, c), (lens, ln), (meta16, m16), (cfv, cf)):
            out[t0:t0 + per] = part
        del x, c, ln, m16, cf
    words, totals, glen = pack_groups_auto(codes, lens, n_words, group_bits_bound(tbits, True))
    return words, totals, glen, meta16, cfv


def encode_tiles(imgs: np.ndarray, mode: int = Mode.FTL, coreband=None,
                 index=False, device="cuda") -> list[bytes]:
    """Encode (N, H, W, C) same-shape tiles in one dispatch -> N streams.

    FTL/BASE, with no sidecar, the "ic" sidecar or (index True / "ix") the
    "ix" sidecar; CF/CF_H (best_encode_tiles), with no sidecar or (index
    True or "ic", as qb3_tpu writes it) the "ib" sidecar.  Each tile's
    stream is byte-identical to a standalone encode.
    """
    if imgs.ndim != 4:
        raise QB3ShapeError("expected (N, H, W, C) tiles")
    n, h, w, nb = imgs.shape
    best = mode in (Mode.CF_H, Mode.CF)
    if (mode not in (Mode.FTL, Mode.BASE_H, Mode.BASE_Z) and not best) or h < B or w < B:
        raise QB3ShapeError("batch encode supports FTL/BASE/BEST tiles >= 4x4")
    dt = DT_FROM_NP[imgs.dtype]
    cband = tuple(coreband) if coreband is not None else tuple(default_cband(nb))
    zorder = mode in (Mode.BASE_Z, Mode.CF)
    order = ZCURVE if zorder else HILBERT
    size = imgs.dtype.itemsize
    uns = imgs.view(UNSIGNED[size])
    n_words = stream_words(w, h, nb, dt)
    dev = torch.device(device)
    if best:
        words, totals, glen, meta16, cfv = best_encode_tiles(uns, order, cband, n_words, dev)
        if index:
            glens, meta16, cfv = glen.cpu().numpy(), meta16.cpu().numpy(), cfv.cpu().numpy()
    else:
        zero = torch.zeros(n, nb, dtype=torch.int64, device=dev)
        words, totals, _, _, glen, rung = fast_encode(
            to_carrier(uns, dev), zero, zero, order, cband, mode == Mode.FTL, 8 * size,
            n_words, lanewise=True)
    if index == "ic" and not best:
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
    elif index and not best:
        glens = glen.cpu().numpy()
    totals = totals.cpu().numpy()
    used = int(totals.max() + 31) // 32
    words = words[:, :used].cpu().numpy().view(np.uint32)
    out = []
    for i in range(n):
        idx, sig = None, b"ix"
        if index and best:
            idx, sig = best_sidecar(glens[i], meta16[i], cfv[i]), b"ib"
        elif index == "ic":
            if int(spans[i].sum()) < 1 << 31:
                idx, sig = pack_ic(spans[i], entry[i], k), b"ic"
        elif index:
            idx = glens[i].astype("<u2").tobytes()
        hdr = container.write_headers(w, h, nb, dt, mode, list(cband), 1,
                                      ZCURVE if zorder else 0, idx, sig)
        out.append(hdr + words_to_bytes(words[i], int(totals[i])))
    return out


def ib_meta(metas: list, tile_words32: int) -> dict:
    """The decode metadata of a batch's "ib" sidecars (api._parse_best_sidecar's
    dicts, one a tile) as one dict over the flat tile layout: each tile's
    value positions moved to its words, tile_words32 u32 words apart."""
    tbase = (np.arange(len(metas), dtype=np.int64) * tile_words32 * 32)[:, None]
    meta = {k: np.stack([m[k] for m in metas]).reshape(-1) for k in ("kind", "vrung", "cf")}
    meta["val_pos"] = (np.stack([m["val_pos"] for m in metas]) + tbase).reshape(-1)
    return meta


def decode_tiles(streams: list[bytes], device="cuda") -> np.ndarray:
    """Decode N same-shape streams in one dispatch -> (N, H, W, C): FTL/BASE
    streams with the "ic" or the "ix" sidecar, best-mode streams with the
    "ib" sidecar.  A best-mode batch with "ic" sidecars raises, as in
    qb3_tpu ("inconsistent ic sidecar": parse_ic refuses best anchors)."""
    infos = [container.parse_headers(s) for s in streams]
    i0 = infos[0]
    if any((i.xsize, i.ysize, i.nbands, i.dtype, i.mode) !=
           (i0.xsize, i0.ysize, i0.nbands, i0.dtype, i0.mode) for i in infos):
        raise QB3ShapeError("batch decode requires same-shape streams")
    best = all(i.index_best is not None for i in infos)
    chunked = all(i.index_chunked is not None for i in infos)
    if not best and not chunked and any(i.index is None for i in infos):
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
    if best:
        metas = [_parse_best_sidecar(i.index_best, nblocks * nb) for i in infos]
        if any(m is None for m in metas):
            raise QB3ShapeError("inconsistent ib sidecar")
        inp = walk_inputs(ib_meta(metas, tile_words32), flat.reshape(-1), tbits, dev)
        g = decode_groups(**inp, tbits=tbits, apply_step=apply_step)
        g = g.reshape(n, nblocks, nb, B2)
    elif chunked:
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
