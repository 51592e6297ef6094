"""The window's entry broken underneath, for the control runs and tests.

A driver names the entry its window drives (ENTRY, "module:function") and
its shape (SHAPE): tiles in batches through a generator or a call, streams
one by one or in batches.  install() replaces that entry, before set-up,
with one of:

  control            the entry with one bit of precision dropped: each
                     tile's lowest bit cleared before an encode, each
                     decoded value's after a decode (the lossless guarantee
                     broken; the chip's control run)
  reference_control  the reference in the program's place with that bit
                     dropped (the tests' control, at a test's size)
  half               half of each batch's answers left out (batches only)
  altered            every answer altered where it is produced: a stream's
                     last byte, a tile's first value
"""

from __future__ import annotations

import importlib

import numpy as np

from .loops import MODES
from .reference import qb3ref

KINDS = ("control", "reference_control", "half", "altered")


def kinds(shape: str) -> tuple:
    """The faults an entry of this shape can have: one request a call has
    no batch to halve."""
    return tuple(k for k in KINDS if not (k == "half" and shape == "array_one"))


def _drop(x: np.ndarray) -> np.ndarray:
    return x - (x & 1)


def _alter_stream(s: bytes) -> bytes:
    return s[:-1] + bytes([s[-1] ^ 1])


def _alter_tiles(a: np.ndarray) -> np.ndarray:
    a = np.array(a)  # (N, H, W, C): each tile's first value
    a.reshape(len(a), -1)[:, 0] ^= 1
    return a


def _ref_streams(conf: dict, tiles) -> list:
    return [qb3ref.encode(_drop(t), MODES[conf["mode"]], conf.get("index"),
                          conf.get("coreband")) for t in tiles]


def _ref_arrays(streams) -> np.ndarray:
    return _drop(np.stack([qb3ref.decode(s) for s in streams]))


def _edit(kind: str, out):
    """A batch's answers (streams or arrays) after a fault of the output."""
    if kind == "half":
        return out[: len(out) // 2]
    if kind == "altered":
        return _alter_tiles(out) if isinstance(out, np.ndarray) else \
            [_alter_stream(s) for s in out]
    return _drop(out) if kind == "control" and isinstance(out, np.ndarray) else out


def _wrap(shape: str, kind: str, conf: dict, fn):
    encode = shape.startswith("stream")
    ref = (lambda x: _ref_streams(conf, x)) if encode else _ref_arrays

    def inputs(x):  # the control's lossy input to an encode
        return _drop(x) if kind == "control" and encode else x

    if shape == "stream_batch":
        def call(x, *a, **kw):
            return ref(x) if kind == "reference_control" else _edit(kind, fn(inputs(x), *a, **kw))
        return call
    if shape in ("stream_batches", "array_batches"):
        def gen(batches, *a, **kw):
            if kind == "reference_control":
                yield from (ref(x) for x in batches)
                return
            for out in fn((inputs(x) for x in batches), *a, **kw):
                yield _edit(kind, out)
        return gen
    if shape == "array_one":
        def one(stream, *a, **kw):
            if kind == "reference_control":
                return ref([stream])[0], None
            img, info = fn(stream, *a, **kw)
            return _edit(kind, img[None])[0], info
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
