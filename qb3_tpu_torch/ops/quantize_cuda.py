"""Wrapper of the CUDA kernel K11 (the step of a quantized encode, with the
widening to the int64 carrier, in one pass over the uploaded raster), with
its twin and launch counter.

K11 replaces no TPU kernel: qb3_tpu quantizes on the host with NumPy
(api.quantize).  Its twin is that same api.quantize on the tensor's NumPy
view, then api.to_carrier's widening.  The wrapper takes the twin for a CPU
tensor and launches the kernel (csrc/quantize.cu) for a CUDA tensor; there
is no fallback from one to the other.  ``quantize_carrier.launches`` counts
the kernel's launches.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from .pack_cuda import on_cpu, require, stream_ptr

_K11 = _build.Kernel("qb3_quantize")
# the tensor types the values arrive in: an unsigned raster's signed view
# (api.to_carrier's), and u8 / i8 both as uint8
SOURCE = {8: torch.uint8, 16: torch.int16, 32: torch.int32, 64: torch.int64}


def quantize_args(values, tbits: int, signed: bool, q: int, away: bool):
    """Check K11's inputs and allocate its output -> (the C entry point's
    arguments but the stream, the int64 output of the values' shape)."""
    if tbits not in SOURCE:
        raise ValueError(f"tbits {tbits}: the kernel takes 8, 16, 32 or 64")
    require(values, SOURCE[tbits], "values")
    top = (1 << (tbits - bool(signed))) - 1
    if not 2 <= q <= top:
        raise ValueError(f"step {q}: the kernel takes 2 to {top} at {tbits} bits")
    out = torch.empty(values.shape, dtype=torch.int64, device=values.device)
    return (values.data_ptr(), values.numel(), tbits, int(bool(signed)), q, int(bool(away)),
            out.data_ptr()), out


def quantize_carrier_plain(values, tbits: int, signed: bool, q: int, away: bool):
    """K11's twin: api.quantize of the values in their type (tbits wide,
    signed or not), then api.to_carrier's widening."""
    from ..api import quantize, to_carrier  # api imports this module

    size = tbits // 8
    native = values.numpy().view(np.dtype(f"{'i' if signed else 'u'}{size}"))
    return to_carrier(quantize(native, q, away).view(np.dtype(f"u{size}")), values.device)


def quantize_carrier(values, tbits: int, signed: bool, q: int, away: bool):
    """K11: the int64 carrier of the quantized values' unsigned twin, equal
    to quantize_carrier_plain's.

    values: a contiguous tensor of tbits-wide values in the type SOURCE
    names for tbits (an unsigned raster's signed view); signed: the
    raster's type, which the tensor's does not say; q from 2 to the type's
    largest value; away: ties away from zero (api.quantize)."""
    if on_cpu(values):
        return quantize_carrier_plain(values, tbits, signed, q, away)
    args, out = quantize_args(values, tbits, signed, q, away)
    if out.numel():
        _K11(*args, stream_ptr(values.device))
        quantize_carrier.launches += 1
    return out


quantize_carrier.launches = 0
