"""Batched multi-tile encode/decode: many same-shape rasters per dispatch.

PyTorch counterpart of qb3_tpu/batch.py.  One K1 launch packs the whole
batch, after one pass of phase A (FTL / BASE) or one pass of the best
modes' phase A for each group of tiles (BEST_GROUPS groups at most a pass:
the twin's index trial, on the CPU, grows with the batch); decode is one K3
+ K2 walk ("ic"), one K4 walk ("ix") or one K7 + K5 pass ("ib", best modes) over
the flat tile layout, then one reconstruct.  Each tile is an independent
QB3 stream (fresh band state), identical to encoding it alone.

Each direction runs in stages, which encode_tiles / decode_tiles call in a
row and pipeline.py overlaps across batches on CUDA streams: a host plan
(plan_encode / plan_decode: checks, sidecar parses, the flat tile layout),
the upload of its inputs (upload_tiles / decode_inputs), the device work
(encode_dispatch / decode_dispatch: device tensors back, no synchronize)
and the host finish (encode_finish / decode_finish: streams or arrays from
the fetched results).  On a CUDA device encode_tiles copies both ways
through page-locked buffers (staged_put, fetch_round); elsewhere the
copies are plain.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import container, framing, profiling
from .api import (_NP_SIGNED, DT_FROM_NP, NP_FROM_DT, UNSIGNED, _fused_ix_params,
                  _parse_best_sidecar, default_cband, fast_encode, ic_inputs, narrow, put_on,
                  stream_words, walk_inputs, widen)
from .constants import B, B2, HILBERT, ZCURVE, DType, Mode
from .errors import QB3ShapeError
from .ops.bitpack import group_bits_bound, pack_groups_auto, words_to_bytes
from .ops.decode import decode_groups, decode_indexed_narrow, payload_words, reconstruct_batch
from .ops.decode_chunked import IC_DEFAULT_K, decode_chunked_auto, parse_ic
from .ops.phase_a_cuda import phase_a_best

# groups (blocks x bands) the best modes' phase A takes in one pass: about
# 21 u8 512x512x3 tiles; on the CPU, ~6 GiB of the twin's index trial
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


def staged_put(device):
    """The batch encode's host-to-device copy (api.put_on's interface): on
    a CUDA device each array goes through a page-locked buffer from
    PyTorch's caching host allocator (reused once warm) and a non-blocking
    copy on the current stream, one batch.staged_uploads a call; elsewhere
    api.put_on's plain copy."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return put_on(dev)

    def put(arr: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.require(arr, requirements=["C", "W"]))
        staged = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        staged.copy_(t)
        profiling.count("batch.staged_uploads")
        # the host allocator keeps `staged` until the copy has run
        return staged.to(dev, non_blocking=True)

    return put


def fetch_round(tensors: dict) -> dict:
    """Device tensors -> host arrays, in one round: on a CUDA device each
    copied into a page-locked tensor without a synchronize, then one wait
    on an event, one batch.staged_fetches; elsewhere .cpu().  The arrays
    are views of the tensors, which they keep alive."""
    dev = next(iter(tensors.values())).device
    if dev.type != "cuda":
        return {k: v.cpu().numpy() for k, v in tensors.items()}
    host = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True).copy_(v, non_blocking=True)
            for k, v in tensors.items()}
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(dev))
    done.synchronize()
    profiling.count("batch.staged_fetches")
    return {k: v.numpy() for k, v in host.items()}


def best_encode_tiles(uns: np.ndarray, order: int, cband: tuple, n_words: int, device):
    """The best modes' batch encode (qb3_tpu's _batch_best_kernel): phase A
    (K10, or its twin on the CPU) for each group of whole tiles of at most
    BEST_GROUPS groups (one tile when a tile has more), into one (N,
    ngroups, S) symbol buffer, then one
    K1 launch -> (words, totals, glen, meta16, cfv).  A tile's symbols are
    the same whatever group it is in.  Each pass's tiles are copied at
    their width by staged_put and widened on the device; on the card the
    copy does not block, so pass k+1's staging runs while pass k's copy and
    phase A do.  Spans (profiling), on the device's current stream:
    batch.upload and encode.phase_a a pass, encode.pack."""
    n, h, w, nb = uns.shape
    size = uns.dtype.itemsize
    tbits = 8 * size
    put = staged_put(device)
    per = max(1, BEST_GROUPS // (((h + B - 1) // B) * ((w + B - 1) // B) * nb))
    codes = lens = meta16 = cfv = None
    for t0 in range(0, n, per):
        k = min(per, n - t0)
        with profiling.span("batch.upload", k, device):
            x = widen(put(uns[t0:t0 + per].view(_NP_SIGNED[size])), size)
        with profiling.span("encode.phase_a", k, device):
            zero = torch.zeros(k, nb, dtype=torch.int64, device=device)
            c, ln, _, _, _, m16, cf, _, _ = phase_a_best(x, zero, zero, zero, order, cband,
                                                         tbits)
            if codes is None:
                codes = c.new_empty((n, *c.shape[1:]))
                lens = ln.new_empty((n, *ln.shape[1:]))
                meta16 = m16.new_empty((n, *m16.shape[1:]))
                cfv = cf.new_empty((n, *cf.shape[1:]))
            for out, part in ((codes, c), (lens, ln), (meta16, m16), (cfv, cf)):
                out[t0:t0 + per] = part
        del x, c, ln, m16, cf
    with profiling.span("encode.pack", n, device):
        words, totals, glen = pack_groups_auto(codes, lens, n_words,
                                               group_bits_bound(tbits, True))
    return words, totals, glen, meta16, cfv


@dataclass
class EncodePlan:
    """One batch encode, as the host plans it.  order is the curve the
    encode walks, header_order the order the header names (0: the mode's
    own), best whether the best modes' phase A runs."""

    uns: np.ndarray  # (N, H, W, C) tiles as unsigned values
    mode: int
    index: object
    cband: tuple
    dt: int
    order: int
    header_order: int
    best: bool
    n_words: int


def plan_encode(imgs: np.ndarray, mode: int = Mode.FTL, coreband=None,
                index=False) -> EncodePlan:
    """encode_tiles' checks and settings for (N, H, W, C) tiles."""
    if imgs.ndim != 4:
        raise QB3ShapeError("expected (N, H, W, C) tiles")
    n, h, w, nb = imgs.shape
    best = mode in (Mode.CF_H, Mode.CF)
    if (mode not in (Mode.FTL, Mode.BASE_H, Mode.BASE_Z) and not best) or h < B or w < B:
        raise QB3ShapeError("batch encode supports FTL/BASE/BEST tiles >= 4x4")
    zorder = mode in (Mode.BASE_Z, Mode.CF)
    dt = DT_FROM_NP[imgs.dtype]
    return EncodePlan(
        uns=imgs.view(UNSIGNED[imgs.dtype.itemsize]), mode=mode, index=index,
        cband=tuple(coreband) if coreband is not None else tuple(default_cband(nb)), dt=dt,
        order=ZCURVE if zorder else HILBERT, header_order=ZCURVE if zorder else 0, best=best,
        n_words=stream_words(w, h, nb, dt))


def upload_tiles(plan: EncodePlan, put) -> torch.Tensor | None:
    """The tiles on the device as the signed twin of their type (api.widen
    makes the carrier), copied by put (staged_put, or pipeline.Lanes.put);
    None for the best modes, whose phase A uploads its passes itself."""
    if plan.best:
        return None
    return put(plan.uns.view(_NP_SIGNED[plan.uns.dtype.itemsize]))


def encode_dispatch(plan: EncodePlan, tiles, device) -> dict:
    """The batch's device work -> device tensors: words (N, n_words) int32
    and totals (N,) int64, and the sidecars' pieces: glen (the "ix" and
    "ib" lengths), spans and entry (the "ic" sidecar, computed on the device
    so that only they cross to the host), meta16 and cfv ("ib").  tiles is
    upload_tiles' tensor."""
    n, h, w, nb = plan.uns.shape
    size = plan.uns.dtype.itemsize
    dev = torch.device(device)
    out = {}
    if plan.best:
        out["words"], out["totals"], glen, meta16, cfv = best_encode_tiles(
            plan.uns, plan.order, plan.cband, plan.n_words, dev)
        if plan.index:
            out.update(glen=glen, meta16=meta16, cfv=cfv)
        return out
    zero = torch.zeros(n, nb, dtype=torch.int64, device=dev)
    out["words"], out["totals"], _, _, glen, rung = fast_encode(
        widen(tiles, size), zero, zero, plan.order, plan.cband, plan.mode == Mode.FTL,
        8 * size, plan.n_words, lanewise=True)
    if plan.index == "ic":
        k = IC_DEFAULT_K
        nblocks = glen.shape[1] // nb
        nchunks = -(-nblocks // k)
        g = torch.zeros(n, nchunks * k * nb, dtype=torch.int64, device=dev)
        g[:, : nblocks * nb] = glen
        out["spans"] = g.reshape(n, nchunks, -1).sum(-1)
        out["entry"] = torch.cat([torch.zeros_like(rung[:, :1]),
                                  rung[:, k - 1 : (nchunks - 1) * k : k]], dim=1)
    elif plan.index:
        out["glen"] = glen
    return out


def encode_finish(plan: EncodePlan, words: np.ndarray, host: dict) -> list[bytes]:
    """The N streams from the fetched results: words (N, >= the longest
    stream's words) u32, host encode_dispatch's other outputs as arrays.
    Three passes over the batch, a span (profiling) each: finish.sidecar,
    finish.headers, finish.bytes.  framing.py gives each tile's sidecar
    ("ib" for any true index in the best modes) and header."""
    n, h, w, nb = plan.uns.shape
    totals = host["totals"]
    pieces = {k: v for k, v in host.items() if k != "totals"}
    with profiling.span("finish.sidecar", n):
        sides = [framing.sidecar(plan.index, **{k: v[i] for k, v in pieces.items()})
                 for i in range(n)]
    with profiling.span("finish.headers", n):
        frame = framing.Frame(w, h, nb, plan.dt, list(plan.cband), 1, plan.header_order)
        hdrs = [frame.header(plan.mode, *side) for side in sides]
    with profiling.span("finish.bytes", n):
        return [hdr + words_to_bytes(words[i], int(totals[i])) for i, hdr in enumerate(hdrs)]


def encode_tiles(imgs: np.ndarray, mode: int = Mode.FTL, coreband=None,
                 index=False, device="cuda") -> list[bytes]:
    """Encode (N, H, W, C) same-shape tiles in one dispatch -> N streams.

    FTL/BASE, with no sidecar, the "ic" sidecar or (index True / "ix") the
    "ix" sidecar; CF/CF_H (best_encode_tiles), with no sidecar or (index
    True or "ic", as qb3_tpu writes it) the "ib" sidecar.  Each tile's
    stream is byte-identical to a standalone encode.  The tiles go up by
    staged_put; the results come back in two rounds of fetch_round (the
    totals and sidecar pieces, then the words the longest stream uses).
    Spans (profiling), of one batch: batch.fetch (both rounds, timed on the
    device too) and batch.finish.
    """
    plan = plan_encode(imgs, mode, coreband, index)
    n = imgs.shape[0]
    with profiling.batch():
        out = encode_dispatch(plan, upload_tiles(plan, staged_put(device)), device)
        words = out.pop("words")
        with profiling.span("batch.fetch", n, words.device):
            host = fetch_round(out)
            used = int(host["totals"].max() + 31) // 32
            words = fetch_round({"words": words[:, :used]})["words"].view(np.uint32)
        with profiling.span("batch.finish", n):
            return encode_finish(plan, words, host)


def ib_meta(metas: list, tile_words32: int) -> dict:
    """The decode metadata of a batch's "ib" sidecars (api._parse_best_sidecar's
    dicts, one a tile) or walks (offsets.parse_offsets', each array flattened
    here) as one dict over the flat tile layout: each tile's value positions
    moved to its words, tile_words32 u32 words apart."""
    tbase = (np.arange(len(metas), dtype=np.int64) * tile_words32 * 32)[:, None]
    meta = {k: np.stack([m[k].reshape(-1) for m in metas]).reshape(-1)
            for k in ("kind", "vrung", "cf")}
    meta["val_pos"] = (np.stack([m["val_pos"].reshape(-1) for m in metas])
                       + tbase).reshape(-1)
    return meta


@dataclass
class DecodePlan:
    """One batch decode, as the host plans it: the streams' geometry, the
    flat tile layout of their payload words, and the path's metadata (for
    "ib" ib_meta's dict, for "ic" parse_ic's results, for "ix" the
    (N, groups) sidecar lengths)."""

    n: int
    h: int
    w: int
    nb: int
    np_dt: type
    order: int
    cband: tuple
    apply_step: bool
    path: str
    flat: np.ndarray  # (N, tile_words32 // 2) u64
    tile_words32: int
    meta: object

    @property
    def size(self) -> int:
        return np.dtype(self.np_dt).itemsize

    @property
    def nblocks(self) -> int:
        return (self.h // B) * (self.w // B)


def same_shape(infos, what: str):
    """The first stream's info; raises unless every stream has its size,
    bands, type and mode."""
    i0 = infos[0]
    if any((i.xsize, i.ysize, i.nbands, i.dtype, i.mode) !=
           (i0.xsize, i0.ysize, i0.nbands, i0.dtype, i0.mode) for i in infos):
        raise QB3ShapeError(f"{what} requires same-shape streams")
    return i0


def require_aligned(i0, what: str):
    if i0.ysize % B != 0 or i0.xsize % B != 0:
        raise QB3ShapeError(f"{what} requires 4-aligned tiles")


def flat_plan(i0, wlists: list, path: str, meta, apply_step: bool) -> DecodePlan:
    """A DecodePlan over the payload words of each stream (wlists), laid
    out flat; raises past the flat walk's 2^31-bit cursors."""
    flat, tile_words32 = _flat_tile_layout(wlists)
    if flat.size * 64 >= 1 << 31:
        # the flat walk carries int32 bit cursors
        raise QB3ShapeError(
            "batch exceeds the 2^31-bit flat-decode limit; split the batch")
    if path == "ib":
        meta = ib_meta(meta, tile_words32)
    return DecodePlan(n=len(wlists), h=i0.ysize, w=i0.xsize, nb=i0.nbands,
                      np_dt=NP_FROM_DT[DType(i0.dtype)], order=i0.order or HILBERT,
                      cband=tuple(i0.cband), apply_step=apply_step, path=path, flat=flat,
                      tile_words32=tile_words32, meta=meta)


def plan_decode(streams: list[bytes]) -> DecodePlan:
    """decode_tiles' checks and sidecar parses."""
    infos = [container.parse_headers(s) for s in streams]
    i0 = same_shape(infos, "batch decode")
    best = all(i.index_best is not None for i in infos)
    chunked = all(i.index_chunked is not None for i in infos)
    if not best and not chunked and any(i.index is None for i in infos):
        raise QB3ShapeError("batch decode needs the ix, ic or ib sidecar")
    require_aligned(i0, "batch decode")
    nblocks, nb = (i0.ysize // B) * (i0.xsize // B), i0.nbands
    wlists = [payload_words(s[i.data_offset:]) for s, i in zip(streams, infos)]
    if best:
        path, meta = "ib", [_parse_best_sidecar(i.index_best, nblocks * nb) for i in infos]
        if any(m is None for m in meta):
            raise QB3ShapeError("inconsistent ib sidecar")
    elif chunked:
        path, meta = "ic", [parse_ic(i.index_chunked, nblocks, nb) for i in infos]
        if any(m is None for m in meta) or any(m[0] != meta[0][0] for m in meta):
            raise QB3ShapeError("inconsistent ic sidecar")
    else:
        glens = [np.frombuffer(i.index, dtype="<u2") for i in infos]
        if any(x.size != nblocks * nb for x in glens):
            raise QB3ShapeError("inconsistent ix sidecar")
        path, meta = "ix", np.stack(glens).astype(np.int32)
    return flat_plan(i0, wlists, path, meta, i0.mode != Mode.FTL)


def decode_inputs(plan: DecodePlan, device, put=None) -> dict:
    """The decode's inputs on `device`: the flat stream words and the path's
    per-group or per-chunk arrays, each copied by put (api.put_on(device)
    if None)."""
    tbits = 8 * plan.size
    flat = plan.flat.reshape(-1)
    put = put or put_on(device)
    if plan.path == "ib":
        return walk_inputs(plan.meta, flat, tbits, device, put)
    if plan.path == "ic":
        return ic_inputs(flat, plan.meta, plan.tile_words32, tbits, device, put)
    nreg, R = _fused_ix_params(plan.meta, tbits, plan.tile_words32)
    return dict(words32=put(flat.view(np.int32)), glens=put(plan.meta), nreg=nreg, R=R)


def decode_dispatch(plan: DecodePlan, inp: dict) -> torch.Tensor:
    """The batch's device work -> (N, H, W, C) tiles on the device as the
    signed twin of their type (api.narrow)."""
    n, nb, nblocks, tbits = plan.n, plan.nb, plan.nblocks, 8 * plan.size
    if plan.path == "ib":
        g = decode_groups(**inp, tbits=tbits, apply_step=plan.apply_step)
        g = g.reshape(n, nblocks, nb, B2)
    elif plan.path == "ic":
        k = inp["k"]
        nchunks_per = -(-nblocks // k)
        g = decode_chunked_auto(inp["words32"], inp["starts"], inp["entry"], k,
                                n * nchunks_per * k, nb, plan.apply_step, tbits,
                                inp["maxw"], inp["R"])
        g = g.reshape(n, nchunks_per * k, nb, B2)[:, :nblocks]
    else:
        g = decode_indexed_narrow(inp["words32"], inp["glens"], nblocks, nb, plan.apply_step,
                                  tbits, n, plan.tile_words32, inp["nreg"], fused=inp["R"])
        g = g.reshape(n, nblocks, nb, B2)
    img = reconstruct_batch(g, plan.h, plan.w, nb, plan.order, plan.cband, tbits)
    return narrow(img, plan.size)


def decode_finish(plan: DecodePlan, tiles: np.ndarray) -> np.ndarray:
    """decode_dispatch's tiles, fetched -> the (N, H, W, C) array in the
    streams' dtype."""
    return tiles.view(UNSIGNED[plan.size]).view(plan.np_dt)


def decode_tiles(streams: list[bytes], device="cuda") -> np.ndarray:
    """Decode N same-shape streams in one dispatch -> (N, H, W, C): FTL/BASE
    streams with the "ic" or the "ix" sidecar, best-mode streams with the
    "ib" sidecar.  A best-mode batch with "ic" sidecars raises, as in
    qb3_tpu ("inconsistent ic sidecar": parse_ic refuses best anchors)."""
    plan = plan_decode(streams)
    tiles = decode_dispatch(plan, decode_inputs(plan, torch.device(device)))
    return decode_finish(plan, tiles.cpu().numpy())
