"""Bulk decode of foreign (sidecar-free) QB3 streams at serving rate.

PyTorch counterpart of qb3_tpu/foreign.py.  A stream the reference encoder
produced carries no sidecar, so recovering per-group bit offsets is a
serial walk (the format's one irreducible serial dependency, SURVEY 3.3).
The one-shot decode pays that walk plus a full device round trip per
image.  This module is the serving path for bulk tiles:

  * the C++ walk (native.py: native/qb3xs.cpp through ctypes.CDLL, which
    releases the GIL during the call) runs THREAD-PARALLEL across the
    streams of a batch, RLE modes with the C++ RLE0 pass first in the same
    threads (QB3decode.cpp:396-413);
  * all walked streams decode in ONE device pass, batch.decode_tiles' "ib"
    path fed with the walks' metadata: K7 gathers each group's window, K5a
    (u8) or K5b decodes it, one reconstruct;
  * decode_streams_pipelined overlaps batch k+1's walks with batch k's
    device decode and fetch (pipeline.py's streams).

Reference bar: QB3decode.h:579 (decode<T>), 354.57 MB/s published on one
Zen3 core (BASELINE.md).  Streams with quanta other than 1, STORED payloads
and tiles whose sides are not multiples of 4 are refused: api.decode takes
them one at a time.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import torch

from . import container, native, rle
from .api import walk_offsets
from .batch import (DecodePlan, decode_dispatch, decode_inputs, flat_plan, require_aligned,
                    same_shape)
from .constants import B, TYPESIZES, Mode, needs_rle
from .errors import QB3ShapeError
from .ops.decode import payload_words
from .pipeline import decode_plans_pipelined


def _walk_one(stream: bytes, info):
    """Host stage for one stream: the RLE0 pass, then the walk ->
    (payload words, the walk's metadata)."""
    payload = stream[info.data_offset:]
    if needs_rle(info.mode):
        payload = rle.rle0_decode(payload, rle.rle0_decoded_size(payload))
    nblocks = (info.ysize // B) * (info.xsize // B)
    meta, _ = walk_offsets(payload, nblocks, info.nbands, TYPESIZES[info.dtype], info.mode)
    if meta["failed"]:
        raise QB3ShapeError(f"corrupt stream (group {meta['failed_group']})")
    return payload_words(payload), meta


def plan_streams(streams: list[bytes], workers: int | None = None) -> DecodePlan:
    """Check a batch of same-shape sidecar-free streams and walk them across
    `workers` threads (default: ThreadPoolExecutor's) -> the plan of their
    device decode."""
    infos = [container.parse_headers(s) for s in streams]
    i0 = same_shape(infos, "bulk foreign decode")
    if i0.quanta != 1 or i0.mode == Mode.STORED:
        raise QB3ShapeError("quantized/stored streams: use qb3_tpu_torch.decode")
    require_aligned(i0, "bulk foreign decode")
    native.load()  # build the C++ library here, not in several threads at once
    with ThreadPoolExecutor(max_workers=workers) as ex:
        walked = list(ex.map(_walk_one, streams, infos))
    return flat_plan(i0, [wv for wv, _ in walked], "ib", [m for _, m in walked],
                     i0.mode != Mode.FTL)


def decode_streams(streams: list[bytes], workers: int | None = None, device="cuda"):
    """Decode a batch of same-shape sidecar-free streams -> ((N, H, W, C)
    tiles on `device` as the signed twin of their type, their numpy dtype):
    ``t.cpu().numpy().view(np_dt)`` gives the arrays.  The walks run across
    `workers` threads; the values decode on the device in one pass."""
    plan = plan_streams(streams, workers)
    return decode_dispatch(plan, decode_inputs(plan, torch.device(device))), plan.np_dt


def decode_streams_pipelined(stream_batches, workers: int | None = None, device="cuda"):
    """Decode an iterable of LISTS of same-shape foreign streams -> yields
    one (N, H, W, C) array per list: batch k+1's thread-parallel walks and
    upload overlap batch k's device decode and fetch (pipeline.py)."""
    return decode_plans_pipelined((plan_streams(s, workers) for s in stream_batches), device)
