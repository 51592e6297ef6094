"""Profiling hooks (SURVEY §5 tracing/observability).

PyTorch counterpart of qb3_tpu/profiling.py.  The reference keeps timing
in its callers (cqb3.cpp:478-481 MB/s prints); here it is a torch.profiler
trace, the same rate counter, and a tracer of the program's own stages:

    with qb3_tpu_torch.profiling.trace("/tmp/qb3-trace"):
        stream = qb3_tpu_torch.encode(img)
    # open the .pt.trace.json file in Perfetto or chrome://tracing

    with qb3_tpu_torch.profiling.meter(img.nbytes) as m:
        qb3_tpu_torch.encode(img)
    print(m.mbps)

    qb3_tpu_torch.profiling.enable()       # the tracer, off by default
    for streams in pipeline.encode_tiles_pipelined(batches, index="ic"):
        store(streams)
    for r in qb3_tpu_torch.profiling.records():
        print(r["name"], r["tiles"], r["host_ms"], r["device_ms"])
    print(qb3_tpu_torch.profiling.counters())

The CLI exposes `--trace DIR` on both directions.

**The tracer.**  The encode paths open a span around each stage of a
batch: the pipeline's upload (``pipeline.upload``, the pinned staging of
``Lanes.put``), its wait on a batch's fetch (``pipeline.fetch_wait``: how
long the host waits for the card, its slack) and its finish
(``pipeline.finish``); the fast and best phase A (``encode.phase_a``) and
K1's pack (``encode.pack``), names that the image-layout encode
(``api.fused_encode``) opens too, around its phase A and K8, with device
ms; the best batch's uploads (``batch.upload``, a pass's staging and
copy), its fetch (``batch.fetch``) and its finish (``batch.finish``);
inside ``batch.encode_finish`` the ``finish.sidecar``, ``finish.headers``
and ``finish.bytes`` passes.  The strip encoder
(``strip.StripEncoder``) opens ``strip.push`` around each push, and inside
it, for each strip the push completes, ``strip.encode`` (the strip's
upload, its step, phase A, its pack and the blocking reads of its exit
state and bit total, with device ms), which holds ``strip.quantize`` where
the step is 2 or more (K11's launch, with device ms; its twin on the CPU)
and, in the fast modes, the strip's ``encode.phase_a`` and ``encode.pack``;
the strip encoder's ``finish()`` is ``strip.finish``, around
``strip.stitch`` (K6's stitch of the strips' words, with device ms),
``strip.bytes`` (the stitched words' download and ``words_to_bytes``,
host ms) and, in an RLE mode, ``finish.rle0`` (the RLE0 post-pass of
``framing.Frame.finish``).  A span records its name,
host start and end (``time.perf_counter_ns``), its parent span, its batch
(every span of one batch shares an id: the pipeline interleaves batch k's
finish with batch k+1's dispatch), its tiles and, opened on a CUDA
device, a pair of timing events on the current stream, resolved to device
ms only when ``records()`` is read: the hot path never synchronizes.  The
records stay in memory, the newest RING of them.  Off, ``span()`` returns
one shared no-op object after one flag test: no clock, no event, no
allocation.

``counters()`` gives every kernel wrapper's ``launches`` by the wrapper's
name (``pack_groups_chunked`` is K1, ``chunkwalk8`` K2, ...) and
``pipeline.cap_misses``: the pipelined encode's batches in which a tile
passed the adaptive fetch cap, so that the batch's words were fetched
again whole, synchronously (a batch that compresses worse than the one
before it; counted whether the tracer is on or not), and
``batch.staged_uploads`` / ``batch.staged_fetches``: the batch encode's
copies through page-locked buffers on a CUDA device (a best pass's or a
batch's upload; a fetch round, two a batch), which the CPU never counts,
and ``strip.strips`` / ``strip.scenes``: the strips the strip encoder
encoded and its ``finish()`` calls (a 6000-row scene pushed in 512-row
pieces at ``strip_rows=512``: 12 and 1), counted whether the tracer is on
or not, as every counter is.

Inside ``trace()`` (the CLI's ``--trace``) the tracer is on and each span
is also a ``torch.profiler.record_function`` range named ``qb3:<stage>``,
beside the kernels in the Chrome trace.  Outside ``trace()`` it opens no
profiler range, so a profile taken around a traced run holds only the
program's own device work; ``profiler_us`` maps a record's host clock onto
such a profile's timeline.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time

import torch

RING = 65536  # spans kept, the newest

_on = False
_in_trace = False
_ring: collections.deque = collections.deque(maxlen=RING)
_anchor = None  # (perf_counter_ns, time_ns) taken by enable()
_ids = itertools.count()
_batch_ids = itertools.count()
_local = threading.local()  # per thread: the open spans' ids, the batch
_COUNTERS = {"pipeline.cap_misses": 0, "batch.staged_uploads": 0, "batch.staged_fetches": 0,
             "strip.strips": 0, "strip.scenes": 0}


class _Noop:
    """What span() and batch() return with the tracer off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


def _thread():
    st = _local
    if not hasattr(st, "stack"):
        st.stack, st.batch = [], None
    return st


class _Span:
    __slots__ = ("name", "tiles", "device", "id", "parent", "batch", "t0", "ev", "rf")

    def __init__(self, name: str, tiles: int, device):
        self.name, self.tiles, self.device = name, tiles, device

    def __enter__(self):
        st = _thread()
        self.id = next(_ids)
        self.parent = st.stack[-1] if st.stack else None
        self.batch = st.batch
        st.stack.append(self.id)
        self.rf = None
        if _in_trace:
            self.rf = torch.profiler.record_function("qb3:" + self.name)
            self.rf.__enter__()
        self.ev = None
        dev = self.device
        if dev is not None and torch.device(dev).type == "cuda":
            stream = torch.cuda.current_stream(dev)
            self.ev = (torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True))
            self.ev[0].record(stream)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self.ev is not None:
            self.ev[1].record(torch.cuda.current_stream(self.device))
        t1 = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        _thread().stack.pop()
        # id, parent, batch, name, tiles, host start and end, events, device ms
        _ring.append([self.id, self.parent, self.batch, self.name, self.tiles, self.t0, t1,
                      self.ev, None])
        return False


class _Batch:
    __slots__ = ("bid", "prev")

    def __init__(self, bid):
        self.bid = next(_batch_ids) if bid is None else bid

    def __enter__(self):
        st = _thread()
        self.prev, st.batch = st.batch, self.bid
        return self.bid

    def __exit__(self, *exc):
        _thread().batch = self.prev
        return False


def enable() -> None:
    """Switch the tracer on; when it was off, start an empty ring of RING
    spans and anchor the host clock to the Unix epoch (profiler_us)."""
    global _on, _ring, _anchor
    if not _on:
        _ring = collections.deque(maxlen=RING)
        _anchor = (time.perf_counter_ns(), time.time_ns())
        _on = True


def disable() -> None:
    """Switch the tracer off; its records stay readable."""
    global _on
    _on = False


def span(name: str, tiles: int = 0, device=None):
    """A context manager around one stage: recorded when the tracer is on
    (with device timing when `device` is a CUDA device), the shared no-op
    when it is off."""
    if not _on:
        return _NOOP
    return _Span(name, tiles, device)


def batch(bid=None):
    """A context manager whose spans belong to one batch: a new batch id
    (None) or `bid`, one given earlier, to return to that batch; entering
    it gives the id (None when the tracer is off)."""
    if not _on:
        return _NOOP
    return _Batch(bid)


def count(name: str) -> None:
    """Add one to a program counter (counters())."""
    _COUNTERS[name] += 1


def records() -> list[dict]:
    """The kept spans, in the order they ended: id, parent (the enclosing
    span's id or None), batch, name, tiles, t0_ns / t1_ns (host
    perf_counter_ns), host_ms and device_ms (the events' elapsed ms on the
    span's stream; None for a span off the card).  Reading waits for the
    events still pending."""
    out = []
    for r in list(_ring):
        if r[7] is not None:
            r[7][1].synchronize()
            r[8] = r[7][0].elapsed_time(r[7][1])
            r[7] = None
        out.append(dict(id=r[0], parent=r[1], batch=r[2], name=r[3], tiles=r[4], t0_ns=r[5],
                        t1_ns=r[6], host_ms=(r[6] - r[5]) / 1e6, device_ms=r[8]))
    return out


def counters() -> dict:
    """Every kernel wrapper's launches (ops/*_cuda.py) by its name, and the
    program's counters (count())."""
    import importlib
    import pkgutil

    from . import ops

    out = {}
    for m in pkgutil.iter_modules(ops.__path__):
        if m.name.endswith("_cuda"):
            mod = importlib.import_module(f"{ops.__name__}.{m.name}")
            for fn in vars(mod).values():
                if hasattr(fn, "launches") and getattr(fn, "__module__", None) == mod.__name__:
                    out[fn.__name__] = fn.launches
    out.update(_COUNTERS)
    return out


def profiler_us(t_ns: int, prof) -> float:
    """A host perf_counter_ns reading (a record's t0_ns / t1_ns) on the
    timeline of a finished torch.profiler profile: us from its start, as
    its events' time_range gives them (the profiler's clock is the Unix
    epoch's; the anchor taken by enable() converts)."""
    pc, wall = _anchor
    start = prof.profiler.kineto_results.trace_start_ns()
    return (t_ns - pc + wall - start) / 1e3


@contextlib.contextmanager
def trace(log_dir: str, host: bool = False):
    """Capture a torch.profiler trace of the block into log_dir, as the
    Chrome trace file qb3.<pid>.<ns>.pt.trace.json: CPU activity, and the
    CUDA device's once CUDA is initialized (its kernels appear by name),
    with the tracer on and its spans as "qb3:<stage>" ranges.
    ``host`` is qb3_tpu's switch for host activity; torch.profiler always
    records the CPU's, so the trace is the same with either value.

    On the H100, once a process is about a minute old, the profiler keeps
    no record of a profile's first few kernels; so the trace first
    launches benchutil's sentinel kernels (torch.cuda._sleep) and waits for
    them, and the block's own kernels come after."""
    from torch.profiler import ProfilerActivity, profile

    from .benchutil import launch_sentinels

    global _in_trace
    cuda = torch.cuda.is_initialized()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    was_on, was_in = _on, _in_trace
    enable()
    _in_trace = True
    try:
        with profile(activities=activities) as prof:
            if cuda:
                launch_sentinels()
            try:
                yield
            finally:
                if cuda:
                    torch.cuda.synchronize()
    finally:
        _in_trace = was_in
        if not was_on:
            disable()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"qb3.{os.getpid()}.{time.time_ns()}.pt.trace.json"))


class _Meter:
    def __init__(self, nbytes: int):
        self.nbytes = nbytes
        self.seconds = 0.0

    @property
    def mbps(self) -> float:
        return self.nbytes / 1e6 / self.seconds if self.seconds else 0.0


@contextlib.contextmanager
def meter(nbytes: int):
    """Wall-clock MB/s counter: waits for the CUDA device's queued work (if
    CUDA is initialized) before it reads the clock."""
    m = _Meter(nbytes)
    t0 = time.perf_counter()
    try:
        yield m
    finally:
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        m.seconds = time.perf_counter() - t0
