"""What the drivers share: the closed-loop window, the open-loop window and
the checks against the reference.

A closed loop's window closes at the first completion at or after
`seconds` from its start, so it holds whole units of work and its rate is
all the work it completed over all its time.  An open loop's window is
its arrival schedule: every request due in it is sent and waited for, and
its latency counts from the time it was due.
"""

from __future__ import annotations

import time

import numpy as np

from .reference import qb3ref

MODES = qb3ref.MODES  # a configuration's "mode" -> the mode's number


def closed_window(step, seconds: float, run, phase: str) -> float:
    """Call step() (one unit of work, which ticks run.done) until the
    first completion at or after `seconds` -> the window's seconds."""
    t0 = run.begin(phase)
    while True:
        step()
        t = time.perf_counter()
        if t - t0 >= seconds:
            return t - t0


def open_window(serve, due, run, phase: str) -> list:
    """Send request i at due[i] seconds from the start (or as soon as the
    one before it has been answered), serve(i) on this thread, FIFO ->
    each request's latency, from its due time to its answer."""
    t0 = run.begin(phase)
    lat = []
    for i, d in enumerate(due):
        wait = t0 + d - time.perf_counter()
        if wait > 0:
            with run.span("arrival_wait"):
                time.sleep(wait)
        serve(i)
        lat.append(time.perf_counter() - t0 - d)
    return lat


def pick(kept: list, n: int, rng: np.random.Generator) -> list:
    """Up to n of the kept (pool index, answer) pairs, drawn by rng, one a
    pool index where the kept ones allow."""
    out, seen = [], set()
    for i in rng.permutation(len(kept)):
        if kept[i][0] not in seen:
            seen.add(kept[i][0])
            out.append(kept[i])
            if len(out) == n:
                break
    return out


def reference_stream(conf: dict, raster: np.ndarray) -> bytes:
    """The plain reference's stream of a raster under a configuration: its
    "mode", "index" (the sidecar), "coreband", "quanta" (the step, 1 where
    the configuration has none) and "away" (ties away from zero; false where
    it has none)."""
    return qb3ref.encode(raster, MODES[conf["mode"]], conf.get("index"), conf.get("coreband"),
                         conf.get("quanta", 1), conf.get("away", False))


def reference_raster(conf: dict, raster: np.ndarray) -> np.ndarray:
    """What the configuration's stream of a raster decodes to: the raster
    itself where the configuration is lossless or its stream stores the raw
    raster, else the raster quantized and multiplied back."""
    q = conf.get("quanta", 1)
    if q < 2 or qb3ref.parse_header(reference_stream(conf, raster))["mode"] == qb3ref.STORED:
        return raster
    return qb3ref.dequantize(qb3ref.quantize(raster, q, conf.get("away", False)), q)


def streams_differ(kept: list, pool: np.ndarray, conf: dict, n: int, rng) -> int:
    """How many of n drawn streams differ from the reference encoder's
    stream of the same raster, header, sidecar and payload."""
    return sum(s != reference_stream(conf, pool[i]) for i, s in pick(kept, n, rng))


def arrays_differ(kept: list, pool: np.ndarray, conf: dict) -> int:
    """How many kept (pool index, decoded array) pairs differ from what the
    stream of the raster they came from decodes to (reference_raster): the
    raster itself in a lossless configuration."""
    def wrong(a, want):
        return a.dtype != want.dtype or a.shape != want.shape or not np.array_equal(a, want)

    return sum(wrong(a, reference_raster(conf, pool[i])) for i, a in kept)
