"""Profiling hooks (SURVEY §5 tracing/observability).

PyTorch counterpart of qb3_tpu/profiling.py.  The reference keeps timing
in its callers (cqb3.cpp:478-481 MB/s prints); here it is a torch.profiler
trace plus the same rate counter:

    with qb3_tpu_torch.profiling.trace("/tmp/qb3-trace"):
        stream = qb3_tpu_torch.encode(img)
    # open the .pt.trace.json file in Perfetto or chrome://tracing

    with qb3_tpu_torch.profiling.meter(img.nbytes) as m:
        qb3_tpu_torch.encode(img)
    print(m.mbps)

The CLI exposes `--trace DIR` on both directions.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str, host: bool = False):
    """Capture a torch.profiler trace of the block into log_dir, as the
    Chrome trace file qb3.<pid>.<ns>.pt.trace.json: CPU activity, and the
    CUDA device's once CUDA is initialized (its kernels appear by name).
    ``host`` is qb3_tpu's switch for host activity; torch.profiler always
    records the CPU's, so the trace is the same with either value.

    On the H100, once a process is about a minute old, the profiler keeps
    no record of a profile's first few kernels; so the trace first
    launches benchutil's sentinel kernels (torch.cuda._sleep) and waits for
    them, and the block's own kernels come after."""
    from torch.profiler import ProfilerActivity, profile

    from .benchutil import launch_sentinels

    cuda = torch.cuda.is_initialized()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        if cuda:
            launch_sentinels()
        try:
            yield
        finally:
            if cuda:
                torch.cuda.synchronize()
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
