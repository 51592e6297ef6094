"""Timing helpers on the CUDA device, counterpart of qb3_tpu/benchutil.py.

PyTorch returns from a launch before the device finishes, so a host clock
without a synchronize times the enqueue.  These helpers bracket the work
with CUDA events on the current stream and synchronize before reading
them; every helper raises when CUDA is absent rather than timing the CPU.
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch

# sha256 of encode(headline_image(), index="ic"): computed with qb3_tpu.encode
# and re-derived from both packages by tests/test_torch_api.py
HEADLINE_SHA256 = "0d9874e5145ee36edf488c1e5525407266c2f652f42903571313940e791b09d9"


def headline_image(h: int = 512, w: int = 512, bands: int = 3, seed: int = 42,
                   dtype=np.uint8) -> np.ndarray:
    """The main path's input: a smooth (H, W, C) raster with grain and hard
    edges, made with integer numpy only (seeded integers, integer box
    smoothing, a gradient), so every machine makes the same bytes.  Wider
    dtypes shift the 8-bit image up by k = bits/2 - 4 and fill the low k
    bits with grain, like a sensor of 8 + k significant bits."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.int64)
    out = np.empty((h, w, bands), np.int64)
    for c in range(bands):
        f = rng.integers(0, 32, size=(h, w), dtype=np.int64)
        for _ in range(2):  # box smoothing: neighbours average in integers
            f = (f + np.roll(f, 1, 0) + np.roll(f, 1, 1) + np.roll(f, (1, 1), (0, 1))) // 4
        f = f + (x * (96 + 16 * c)) // w + (y * 64) // h + 40
        f[(x + 2 * y) % 61 < 2] += 60  # edges: rung jumps
        out[:, :, c] = np.clip(f, 0, 255)
    if np.dtype(dtype).itemsize == 1:
        return out.astype(dtype)
    k = 4 * np.dtype(dtype).itemsize - 4
    grain = rng.integers(0, 1 << k, size=out.shape, dtype=np.int64)
    return ((out.astype(np.uint64) << np.uint64(k))
            | grain.astype(np.uint64)).astype(dtype)


def _require_cuda():
    if not torch.cuda.is_available():
        raise RuntimeError("device timing needs a CUDA device")


def sustained(fn, iters: int = 30) -> float:
    """Sustained seconds per call: one warm-up call, then ``iters`` calls
    queued back to back between two events, one synchronize at the end."""
    _require_cuda()
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / iters


def median_ms(fn, iters: int = 20) -> float:
    """Median milliseconds of one call, each call between its own events."""
    _require_cuda()
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_seconds(fn, iters: int = 5) -> float:
    """Mean host-clock seconds per call of a host-to-host function (its
    result is on the host, so the device has finished when it returns)."""
    _require_cuda()
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters
