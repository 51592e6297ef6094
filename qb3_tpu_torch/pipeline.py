"""Pipelined host-to-host serving API: overlapped upload / compute / fetch.

PyTorch counterpart of qb3_tpu/pipeline.py.  The one-shot encode() and
decode() pay the whole host-device round trip per call: upload, device
work, fetch, one after another.  This module streams BATCHES of same-shape
tiles through a three-stage software pipeline:

    upload batch k+1  |  device codec batch k  |  fetch + container batch k-1

qb3_tpu gets the overlap from XLA's asynchronous dispatch and
``copy_to_host_async``.  On a CUDA device it is built here explicitly
(Lanes): the inputs are copied from page-locked host buffers on an upload
stream; the batch's kernels run on a compute stream that waits on the
upload's event; the results are copied into page-locked buffers on a fetch
stream that waits on the compute's event, with an event recorded after
them; and the host finishes batch k-1 (waits on its fetch event, writes the
containers) while batch k computes.  Nothing between a batch's upload and
its fetch synchronizes: the encode fetches a compressed prefix of the
words sized from an earlier batch (the adaptive fetch cap) and falls back
to the retained device buffer when a tile passes it.  On the CPU the same
stages run in order.

The streams are qb3_tpu's pipeline's byte for byte, whatever the mode:
its encode always walks the Hilbert curve with the fast modes' phase A and
writes order 0 into the header, so a BASE_Z batch gets an SC chunk naming
the Hilbert curve and a CF_H batch fast-mode codes behind the CF_H byte;
both decode to their tiles.  Peak rate needs three batches or more (fill,
steady state, drain).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .api import DT_FROM_NP, UNSIGNED, default_cband, stream_words
from .batch import (EncodePlan, decode_dispatch, decode_finish, decode_inputs,
                    encode_dispatch, encode_finish, plan_decode, upload_tiles)
from .constants import HILBERT, Mode


@functools.cache
def _streams(device: torch.device) -> tuple:
    """The upload, compute and fetch streams of a CUDA device, made once a
    process.  The caching allocator reuses a freed block only for the
    stream it was allocated on: fresh streams for every run would strand
    the last run's blocks, and the reserved memory would grow until an
    allocation fails and every cached block is released, a stall of
    hundreds of ms."""
    return tuple(torch.cuda.Stream(device) for _ in range(3))


class Lanes:
    """The stages' streams on one device.  On a CUDA device: an upload
    stream, a compute stream and a fetch stream, each stage ordered after
    the one before by an event, host buffers page-locked; on the CPU each
    stage runs at once and its event is None."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        if self.cuda:
            if self.device.index is None:
                self.device = torch.device("cuda", torch.cuda.current_device())
            self.up, self.run, self.down = _streams(self.device)

    def _on(self, stream, after, fn, *args):
        """fn(*args) with `stream` current, after the event `after` (if
        any) -> (its result, the event recorded after it)."""
        if not self.cuda:
            return fn(*args), None
        with torch.cuda.stream(stream):
            if after is not None:
                stream.wait_event(after)
            out = fn(*args)
            done = torch.cuda.Event()
            done.record(stream)
        return out, done

    def put(self, arr: np.ndarray) -> torch.Tensor:
        """A host array on the device, copied through a page-locked buffer
        without a synchronize (call it on the upload stream)."""
        t = torch.from_numpy(np.require(arr, requirements=["C", "W"]))
        if not self.cuda:
            return t
        staged = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        staged.copy_(t)
        # the host allocator keeps `staged` until the copy has run
        return staged.to(self.device, non_blocking=True)

    def upload(self, fn, *args):
        """fn(*args) on the upload stream -> (result, event)."""
        return self._on(self.up if self.cuda else None, None, fn, *args)

    def compute(self, after, fn, *args):
        """fn(*args) on the compute stream once `after` has passed ->
        (result, event)."""
        return self._on(self.run if self.cuda else None, after, fn, *args)

    def fetch(self, after, tensors: dict):
        """Copy each device tensor to the host once `after` has passed ->
        ({name: host tensor}, event); the host tensors are page-locked on a
        CUDA device and hold their values once the event has passed."""
        def copy():
            if not self.cuda:
                return {k: v.cpu() for k, v in tensors.items()}
            return {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                    .copy_(v, non_blocking=True) for k, v in tensors.items()}

        return self._on(self.down if self.cuda else None, after, copy)

    @staticmethod
    def wait(event) -> None:
        if event is not None:
            event.synchronize()


def _plan(tiles: np.ndarray, mode: int, coreband, index) -> EncodePlan:
    """qb3_tpu's pipelined encode settings: the Hilbert curve and the fast
    modes' phase A (with the step skipped for FTL), order 0 in the header."""
    n, h, w, nb = tiles.shape
    dt = DT_FROM_NP[tiles.dtype]
    return EncodePlan(uns=tiles.view(UNSIGNED[tiles.dtype.itemsize]), mode=mode, index=index,
                      cband=tuple(coreband) if coreband is not None else
                      tuple(default_cband(nb)), dt=dt, order=HILBERT, header_order=0,
                      best=False, n_words=stream_words(w, h, nb, dt))


def encode_tiles_pipelined(batches, mode: int = Mode.FTL, coreband=None, index=False,
                           device="cuda"):
    """Encode an iterable of (N, H, W, C) same-shape tile batches -> yields
    one list of container streams per batch, double-buffered: batch k's
    streams are written while batch k+1 is on the device.  index: False,
    True / "ix" or "ic", as batch.encode_tiles takes it."""
    lanes = Lanes(device)
    pending = None
    cap_words = None  # adaptive fetch cap, learned from an earlier batch

    def finish(plan, full, cap, fetched, event, *keep):
        lanes.wait(event)
        host = {k: v.numpy() for k, v in fetched.items()}
        words = host.pop("words")
        need = int((host["totals"].max() + 31) >> 5)
        if need > cap:
            # rare: a tile compressed worse than the fetch cap, so its row
            # comes from the retained full buffer (the batch has finished)
            words = full.cpu().numpy()
        return encode_finish(plan, words.view(np.uint32), host), max(need, 1)

    for tiles in batches:
        plan = _plan(tiles, mode, coreband, index)
        x, up = lanes.upload(upload_tiles, plan, lanes.put)
        out, done = lanes.compute(up, encode_dispatch, plan, x, lanes.device)
        # fetch only the compressed prefix of the words: the cap is the
        # worst tile of the last finished batch + 12.5%, bucketed to
        # n_words / 8 (finish falls back to the full buffer past it)
        n_words = plan.n_words
        bucket = max(1, n_words // 8)
        cap = n_words if cap_words is None else \
            min(n_words, -(-min(n_words, cap_words + bucket) // bucket) * bucket)
        full = out.pop("words")
        fetched, event = lanes.fetch(done, dict(out, words=full[:, :cap]))
        if pending is not None:
            streams, cap_words = finish(*pending)
            yield streams
        # x and out stay referenced until the batch's fetch has passed
        pending = (plan, full, cap, fetched, event, x, out)
    if pending is not None:
        yield finish(*pending)[0]


def decode_plans_pipelined(plans, device="cuda"):
    """Decode an iterable of batch.DecodePlan -> yields one (N, H, W, C)
    array per plan, double-buffered: the next plan is made (its streams
    parsed, or walked by foreign.py) while this one is on the device."""
    lanes = Lanes(device)
    pending = None

    def finish(plan, fetched, event, *keep):
        lanes.wait(event)
        return decode_finish(plan, fetched["tiles"].numpy())

    for plan in plans:
        inp, up = lanes.upload(decode_inputs, plan, lanes.device, lanes.put)
        tiles, done = lanes.compute(up, decode_dispatch, plan, inp)
        fetched, event = lanes.fetch(done, {"tiles": tiles})
        if pending is not None:
            yield finish(*pending)
        # inp and tiles stay referenced until the batch's fetch has passed
        pending = (plan, fetched, event, inp, tiles)
    if pending is not None:
        yield finish(*pending)


def decode_tiles_pipelined(stream_batches, device="cuda"):
    """Decode an iterable of LISTS of same-shape sidecar-bearing streams ->
    yields one (N, H, W, C) array per list, double-buffered (the dual of
    encode_tiles_pipelined; "ix", "ic" and "ib" sidecars as in
    batch.decode_tiles, whose checks and limits it keeps)."""
    return decode_plans_pipelined(map(plan_decode, stream_batches), device)
