"""The window's entry broken underneath, for the control runs and tests.

A driver names the entry its window drives (ENTRY, "module:attribute") and
its shape (SHAPE): tiles in batches through a generator or a call
("stream_batches", "stream_batch"), streams one by one or in batches
("array_one", "array_batches"), or a scene fed in rows ("stream_scene": a
class built with the raster's width, height, bands and settings, fed by
push(rows) and closed by finish() -> the stream, as
qb3_tpu_torch.strip.StripEncoder).  install() replaces that entry, before
set-up, with one of:

  control            the entry with one bit of precision dropped: each
                     value's lowest bit cleared before an encode, each
                     decoded value's after a decode (the lossless guarantee
                     broken; the chip's control run).  In a configuration
                     quantized by a step q the bit is the lowest of the
                     value's step, each value taken toward zero to a
                     multiple of 2q: its own lowest bit is below the
                     precision, and a rounding can hide it.
  reference_control  the reference in the program's place with that bit
                     dropped (the tests' control, at a test's size)
  half               half of each batch's answers left out (batches only)
  altered            every answer altered where it is produced: a stream's
                     last byte, a tile's first value

A driver looks its entry up in the entry's module each time it calls or
builds it (strip.StripEncoder(...), not a name imported at set-up), so
that the replacement is what its window drives.
"""

from __future__ import annotations

import functools
import importlib

import numpy as np

from .loops import reference_stream
from .reference import qb3ref

KINDS = ("control", "reference_control", "half", "altered")


def kinds(shape: str) -> tuple:
    """The faults an entry of this shape can have: one request or one scene
    a call has no batch to halve."""
    return tuple(k for k in KINDS
                 if not (k == "half" and shape in ("array_one", "stream_scene")))


def _drop(x: np.ndarray, conf: dict) -> np.ndarray:
    """x with one bit of precision dropped: its lowest bit, or where the
    configuration's step q ("quanta") is 2 or more the lowest bit of its
    step (toward zero, within the type)."""
    q = conf.get("quanta", 1)
    if q < 2:
        return x - (x & 1)
    v = x.astype(np.int64)
    a = np.abs(v)
    return (np.sign(v) * (a - a % (2 * q))).astype(x.dtype)


def _alter_stream(s: bytes) -> bytes:
    return s[:-1] + bytes([s[-1] ^ 1])


def _alter_tiles(a: np.ndarray) -> np.ndarray:
    a = np.array(a)  # (N, H, W, C): each tile's first value
    a.reshape(len(a), -1)[:, 0] ^= 1
    return a


def _ref_streams(conf: dict, tiles) -> list:
    return [reference_stream(conf, _drop(t, conf)) for t in tiles]


def _ref_arrays(conf: dict, streams) -> np.ndarray:
    return _drop(np.stack([qb3ref.decode(s) for s in streams]), conf)


def _edit(kind: str, conf: dict, out):
    """A batch's answers (streams or arrays) after a fault of the output."""
    if kind == "half":
        return out[: len(out) // 2]
    if kind == "altered":
        return _alter_tiles(out) if isinstance(out, np.ndarray) else \
            [_alter_stream(s) for s in out]
    if kind == "control" and isinstance(out, np.ndarray):
        return _drop(out, conf)
    return out


def _scene(kind: str, conf: dict, cls):
    """The streaming entry cls under a fault: a subclass built as cls is."""

    class Scene(cls):
        @functools.wraps(cls.__init__)
        def __init__(self, width, height, bands, *a, **kw):
            super().__init__(width, height, bands, *a, **kw)
            self._fault_rows = (width, bands, [])

        def push(self, rows):
            if kind == "reference_control":
                width, bands, kept = self._fault_rows
                kept.append(np.asarray(rows).reshape(-1, width, bands).copy())
            else:
                super().push(_drop(np.asarray(rows), conf) if kind == "control" else rows)

        def finish(self) -> bytes:
            if kind == "reference_control":
                return _ref_streams(conf, [np.concatenate(self._fault_rows[2])])[0]
            out = super().finish()
            return _alter_stream(out) if kind == "altered" else out

    return Scene


def _wrap(shape: str, kind: str, conf: dict, fn):
    if shape == "stream_scene":
        return _scene(kind, conf, fn)
    encode = shape.startswith("stream")
    ref = (lambda x: _ref_streams(conf, x)) if encode else (lambda x: _ref_arrays(conf, x))

    def inputs(x):  # the control's lossy input to an encode
        return _drop(x, conf) if kind == "control" and encode else x

    if shape == "stream_batch":
        def call(x, *a, **kw):
            if kind == "reference_control":
                return ref(x)
            return _edit(kind, conf, fn(inputs(x), *a, **kw))
        return call
    if shape in ("stream_batches", "array_batches"):
        def gen(batches, *a, **kw):
            if kind == "reference_control":
                yield from (ref(x) for x in batches)
                return
            for out in fn((inputs(x) for x in batches), *a, **kw):
                yield _edit(kind, conf, out)
        return gen
    if shape == "array_one":
        def one(stream, *a, **kw):
            if kind == "reference_control":
                return ref([stream])[0], None
            img, info = fn(stream, *a, **kw)
            return _edit(kind, conf, img[None])[0], info
        return one
    raise ValueError(f"no faults for shape {shape!r}")


def install(kind: str):
    """A faults= hook for harness.execute: replaces the driver's entry."""
    if kind not in KINDS:
        raise ValueError(kind)

    def hook(cell: dict, driver) -> list:
        mod_name, attr = driver.ENTRY.split(":")
        mod = importlib.import_module(mod_name)
        fn = getattr(mod, attr)
        setattr(mod, attr, _wrap(driver.SHAPE, kind, cell["config"], fn))
        return [(mod, attr, fn)]

    return hook
