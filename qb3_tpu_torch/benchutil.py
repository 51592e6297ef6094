"""Timing helpers on the CUDA device, counterpart of qb3_tpu/benchutil.py.

PyTorch returns from a launch before the device finishes, so a host clock
without a synchronize times the enqueue.  :func:`sync` is the barrier: it
waits for every stream of every CUDA device that a result's tensors lie on.
:func:`sustained_stats` reads the host clock around queued calls and that
barrier; the other helpers bracket the work with CUDA events on the current
stream and synchronize before reading them.  Every timing helper raises
when CUDA is absent rather than timing the CPU.
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch

# sha256 of encode(headline_image(), index="ic"): computed with qb3_tpu.encode
# and re-derived from both packages by tests/test_torch_api.py
HEADLINE_SHA256 = "0d9874e5145ee36edf488c1e5525407266c2f652f42903571313940e791b09d9"

# the repository's Landsat-style sample, a CF_H stream without a sidecar of a
# 512x512x8 u16 tile (the shape of the bench row ftl-u16x8-landsat), and the
# sha256 of its decoded array's bytes: computed with qb3_tpu.decode and
# re-derived from both packages by tests/test_torch_walk.py
LANDSAT_SAMPLE = "web/sample_landsat8.qb3"
LANDSAT_SHA256 = "ae926ac98a0bcc7b89b9d83f3c774597d283f10df448bb4a77f90c61aa1ba2a9"
# sha256 of the Landsat sample's array encoded again in its mode (CF_H) and
# core bands: computed with qb3_tpu.encode (the sample's own bytes) and
# re-derived from both packages by tests/test_torch_best.py
LANDSAT_ENCODE_SHA256 = "a43370c26b9aeeb264b282f9f7a969f16ed60daffd49ef2c0eace3cf241aa2e9"

# sha256 of encode(headline_image(), mode=Mode.CF_H, index=...) with the
# best modes' two sidecars, "ib" (index=True) and "ic": computed with
# qb3_tpu.encode and re-derived from both packages by tests/test_torch_best.py
BEST_HEADLINE_SHA256 = {
    "ib": "47642b825693b022de47c71add157f047440e53496b5df0b9ceb2fc95816280b",
    "ic": "5c868d45d7f100fafbd73911d87020d88ea9074745d7c30786b5e41f32dbd1e8",
}

# the wide rasters of the bench rows ftl-u16, ftl-u16x8-landsat, ftl-u32 and
# ftl-u64: label -> headline_image arguments (h, w, bands, seed, dtype)
WIDE_IMAGES = {
    "u16 1024x1024x1": (1024, 1024, 1, 7, np.uint16),
    "u16 512x512x8": (512, 512, 8, 11, np.uint16),
    "u32 1024x1024x1": (1024, 1024, 1, 12, np.uint32),
    "u64 1024x1024x1": (1024, 1024, 1, 13, np.uint64),
}
# sha256 of encode(image, index=True) for each: computed with qb3_tpu.encode
# and re-derived from both packages by tests/test_torch_encode_image.py
WIDE_SHA256 = {
    "u16 1024x1024x1": "7abfa90134a5146333831f981f61b4022ac93ebc547feb84f4436a266646c9ee",
    "u16 512x512x8": "9ad041feddfb700843b9a2a3a38f1810b3ed5f0c36d637d02bc60345f89f2bdd",
    "u32 1024x1024x1": "273285cc6bc624761bf777dbd1a010a835f2c49f2620f9a0e0dbc796bad4476a",
    "u64 1024x1024x1": "e0ef5e78dd8bcc29955a92916f704b71c751dc0cc58413623e8e0311eea1d9e4",
}


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


def wide_image(label: str) -> np.ndarray:
    """The WIDE_IMAGES raster of `label`."""
    h, w, bands, seed, dtype = WIDE_IMAGES[label]
    return headline_image(h, w, bands, seed=seed, dtype=dtype)


def _require_cuda():
    if not torch.cuda.is_available():
        raise RuntimeError("device timing needs a CUDA device")


def _tensors(tree):
    """The torch.Tensor leaves of a tree of tuples (namedtuples too), lists
    and dicts (by value), in order; other leaves are left out."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


def sync(tree) -> None:
    """Hard barrier: wait for every CUDA device that a tensor of ``tree``
    lies on, one torch.cuda.synchronize per device.

    A synchronize covers every stream of its device, so the work of
    pipeline.py's streams and of parallel/sharded.py's shards on other
    devices is waited for too; a fetch would wait for the current stream
    alone.  Only CUDA tensors take part: host results (bytes, numpy arrays,
    ints, plans, CPU tensors) are complete when they are returned, and a
    tree without a CUDA tensor returns at once, without CUDA too."""
    for d in {x.device for x in _tensors(tree) if x.is_cuda}:
        torch.cuda.synchronize(d)


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


def sustained_stats(fn, iters: int = 30, windows: int = 3):
    """(mean seconds per call, relative sigma) over ``windows`` independent
    timing windows, so a row carries its own error bar: qb3_tpu's
    arithmetic.

    One warm-up call; each window then queues the full ``iters`` calls
    between the host clock and :func:`sync` of the last result, so the one
    trailing barrier is amortized as in :func:`sustained`; sigma is the
    population std of the windows' means over their mean (0.0 for a zero
    mean).  The host clock and sync, not CUDA events on the current stream,
    so the work of other streams and devices is timed too.  Only the latest
    result is kept, where qb3_tpu keeps a window's list: 100 results of a
    128-tile encode would not fit in an H100's 80 GB.  One sync after a
    trivial op costs 10.0-10.9 us (median of 200, two runs of
    chip_smoke.py phase 8 on an NVIDIA H100 80GB HBM3 at 700 W); a call
    much shorter than that needs ``iters`` large enough to hide it."""
    _require_cuda()
    sync(fn())
    ts = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn()
        sync(out)
        ts.append((time.perf_counter() - t0) / iters)
    mean = float(np.mean(ts))
    return mean, float(np.std(ts) / mean) if mean else 0.0


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


# the host-clock margin on either side of the profiled calls, and the
# sentinel kernels launched first in every profile (device_profile)
_PROFILE_PAD_S = 0.02
_PROFILE_SENTINELS = 16
_SENTINEL_KERNEL = "spin_kernel"  # torch.cuda._sleep's


def launch_sentinels() -> None:
    """Launch the sentinel kernels (torch.cuda._sleep) that open every
    profile here, and wait for them: once a process is about a minute old,
    torch.profiler on the H100 keeps no record of a profile's first few
    kernels (device_profile)."""
    for _ in range(_PROFILE_SENTINELS):
        torch.cuda._sleep(100)
    torch.cuda.synchronize()


def _union_ms(spans) -> float:
    """The time covered by (start, end) us intervals, in ms."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total / 1e3


def device_profile(fn, iters: int = 10) -> dict:
    """Where a call's device time goes: torch.profiler over ``iters`` calls
    after a warm-up.  Returns per call: wall_ms (host clock to a
    synchronize, profiler overhead included), busy_ms (the summed time of
    the device's kernels and copies; on one stream they do not overlap),
    idle (1 - busy / wall, an upper bound), active_ms (the time at least one
    of them ran: busy_ms on one stream, less where streams overlap) and
    active_idle (1 - active / wall), ops (device operations), the operation
    with the most device time (top, top_ms) and every operation's device ms
    (per_op).

    On the H100 a profile loses device records.  Once a process is about a
    minute old, the first few kernels of every profile (6 in a check of
    torch 2.11, CUDA 12.8) leave no record; so each profile first launches
    16 sentinel kernels (torch.cuda._sleep), waits for them and leaves them
    out.  Now and then a profile also loses some or all of the rest, and
    the profiler can date a record before its own launch; so the calls sit
    20 ms inside the window on either side, and a profile that lacks a
    device kernel for a recorded kernel launch is taken again, up to five
    times in all (attempts).  If none is whole, the one with the most
    kernels is kept and lost counts what it lacks; only five profiles
    without a device record raise."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _require_cuda()
    fn()
    torch.cuda.synchronize()
    best = None
    for attempts in range(1, 6):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            launch_sentinels()
            time.sleep(_PROFILE_PAD_S)
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / iters
            time.sleep(_PROFILE_PAD_S)
        per_name, spans = {}, []
        n = kernels = 0
        launches = -_PROFILE_SENTINELS
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                if _SENTINEL_KERNEL in e.name:
                    continue
                per_name[e.name] = (per_name.get(e.name, 0.0)
                                    + e.time_range.elapsed_us() / 1e3 / iters)
                spans.append((e.time_range.start, e.time_range.end))
                n += 1
                kernels += not e.name.startswith(("Memset", "Memcpy"))
            elif "LaunchKernel" in e.name:
                launches += 1
        if per_name and (best is None or kernels > best[2]):
            best = (wall, per_name, kernels, n, max(launches - kernels, 0),
                    _union_ms(spans) / iters)
        if per_name and kernels >= launches:
            break
    if best is None:
        raise RuntimeError("five profiles recorded no device activity")
    wall, per_name, _, n, lost, active = best
    busy = sum(per_name.values())
    top = max(per_name, key=per_name.get)
    return dict(wall_ms=wall, busy_ms=busy, idle=1 - busy / wall, active_ms=active,
                active_idle=1 - active / wall, ops=n / iters, top=top,
                top_ms=per_name[top], per_op=per_name, attempts=attempts, lost=lost)


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
