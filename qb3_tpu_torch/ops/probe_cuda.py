"""Wrappers of the CUDA kernels P1-P7 (csrc/probes.cu), their plain PyTorch
twins and launch counters.

Counterparts of the Mosaic probes of tools/probe_mosaic.py, one pallas_call
each: the dim-0 contraction Aᵀ·B (P1), a 1-D copy at an offset read from
device memory (P2), an in-kernel (R, C) -> (1, R * C) flatten (P3, and P7
at a larger shape), a copy of a middle-dim slice at an offset read from
device memory (P4), a write into a column window of an output the kernel
zeroes (P5) and a column concatenation of x, x + 1, ... (P6).  A wrapper
takes its twin for a CPU tensor and launches the kernel for a CUDA tensor;
there is no fallback from one to the other.  qb3_tpu_torch/probes.py runs
them as the probes run theirs.  `empty` launches an empty kernel, the launch
floor that chip_smoke.py and ab_probes.py time beside the kernels.
"""

from __future__ import annotations

import torch

from .. import _build
from .pack_cuda import on_cpu, require, stream_ptr

_P1 = _build.Kernel("qb3_probe_dim0_dot")
_P2 = _build.Kernel("qb3_probe_dma_1d")
_P3 = _build.Kernel("qb3_probe_flatten")  # P3 and P7
_P4 = _build.Kernel("qb3_probe_dma_3d")
_P5 = _build.Kernel("qb3_probe_lane_write")
_P6 = _build.Kernel("qb3_probe_lane_concat")
_EMPTY = _build.Kernel("qb3_empty")


def dim0_dot_plain(a, b):
    """P1's twin: aᵀ·b of (K, M) and (K, N) bf16 -> (M, N) float32, the
    products (exact in float64) summed in float64 and rounded to float32
    once.  The kernel sums in float32 on the tensor cores, in its own
    order: equal to the twin where every partial sum is an integer below
    2^24, else within 2^-16 of the sum of |a_km b_kn| (the tests' bound)."""
    return (a.double().T @ b.double()).float()


def dim0_dot(a, b):
    """P1: a (K, M), b (K, N) bfloat16 -> (M, N) float32 = aᵀ·b, computed
    by the kernel on the tensor cores (no library product)."""
    if on_cpu(a):
        return dim0_dot_plain(a, b)
    require(a, torch.bfloat16, "a", 2)
    require(b, torch.bfloat16, "b", 2, a.device)
    if a.shape[0] != b.shape[0]:
        raise ValueError(f"contraction {a.shape[0]} vs {b.shape[0]}")
    (K, M), N = a.shape, b.shape[1]
    out = torch.empty(M, N, dtype=torch.float32, device=a.device)
    _P1(a.data_ptr(), b.data_ptr(), K, M, N, out.data_ptr(), stream_ptr(a.device))
    dim0_dot.launches += 1
    return out


def dma_1d_plain(src, offs, length: int):
    """P2's twin: out[t, i] = src[offs[t] + i], zero outside src."""
    idx = offs.to(torch.int64)[:, None] + torch.arange(length, device=src.device)
    live = (idx >= 0) & (idx < src.shape[0])
    return torch.where(live, src[torch.where(live, idx, 0)], 0).to(src.dtype)


def dma_1d(src, offs, length: int):
    """P2: src (n,) int32, offs (T,) int32 on the same device (the kernel
    reads them there) -> (T, length) int32 copies src[offs[t]:][:length]."""
    if on_cpu(src):
        return dma_1d_plain(src, offs, length)
    require(src, torch.int32, "src", 1)
    require(offs, torch.int32, "offs", 1, src.device)
    out = torch.empty(offs.shape[0], length, dtype=torch.int32, device=src.device)
    _P2(src.data_ptr(), src.shape[0], offs.data_ptr(), offs.shape[0], length, out.data_ptr(),
        stream_ptr(src.device))
    dma_1d.launches += 1
    return out


def flatten_plain(x):
    """P3's and P7's twin: (R, C) -> (1, R * C), by each output's row and
    column."""
    j = torch.arange(x.numel(), device=x.device)
    return x[j // x.shape[1], j % x.shape[1]].reshape(1, -1)


def _flatten(x, counter):
    if on_cpu(x):
        return flatten_plain(x)
    require(x, torch.int32, "x", 2)
    out = torch.empty(1, x.numel(), dtype=torch.int32, device=x.device)
    _P3(x.data_ptr(), x.shape[0], x.shape[1], out.data_ptr(), stream_ptr(x.device))
    counter.launches += 1
    return out


def flatten(x):
    """P3: x (R, C) int32 -> (1, R * C) int32, at the probe's (4, 128)."""
    return _flatten(x, flatten)


def flatten_big(x):
    """P7: P3's kernel at the probe's (544, 8), the place stage's word
    grid."""
    return _flatten(x, flatten_big)


def dma_3d_plain(src, off, length: int):
    """P4's twin: src[:, off:off + length, :], zero outside src."""
    rows = off.to(torch.int64)[0] + torch.arange(length, device=src.device)
    live = (rows >= 0) & (rows < src.shape[1])
    out = src[:, torch.where(live, rows, 0), :]
    return torch.where(live[None, :, None], out, 0).to(src.dtype)


def dma_3d(src, off, length: int):
    """P4: src (D0, D1, D2) int32, off (1,) int32 on the same device (the
    kernel reads it there) -> (D0, length, D2) int32."""
    if on_cpu(src):
        return dma_3d_plain(src, off, length)
    require(src, torch.int32, "src", 3)
    require(off, torch.int32, "off", 1, src.device)
    out = torch.empty(src.shape[0], length, src.shape[2], dtype=torch.int32, device=src.device)
    _P4(src.data_ptr(), *src.shape, off.data_ptr(), length, out.data_ptr(),
        stream_ptr(src.device))
    dma_3d.launches += 1
    return out


def lane_write_plain(x, width: int, col: int):
    """P5's twin: x in columns col .. col + W of zeros (R, width)."""
    c = torch.arange(width, device=x.device)
    live = (c >= col) & (c < col + x.shape[1])
    return torch.where(live, x[:, torch.where(live, c - col, 0)], 0).to(x.dtype)


def lane_write(x, width: int, col: int):
    """P5: x (R, W) int32 -> (R, width) int32, zero but columns col .. col
    + W, which hold x; the kernel writes the zeros too."""
    if on_cpu(x):
        return lane_write_plain(x, width, col)
    require(x, torch.int32, "x", 2)
    out = torch.empty(x.shape[0], width, dtype=torch.int32, device=x.device)
    _P5(x.data_ptr(), x.shape[0], x.shape[1], width, col, out.data_ptr(),
        stream_ptr(x.device))
    lane_write.launches += 1
    return out


def lane_concat_plain(x, copies: int):
    """P6's twin: [x, x + 1, ..., x + copies - 1] along the columns, by each
    output column's source column and copy."""
    c = torch.arange(x.shape[1] * copies, device=x.device)
    return (x[:, c % x.shape[1]] + c // x.shape[1]).to(x.dtype)


def lane_concat(x, copies: int):
    """P6: x (R, W) int32 -> (R, W * copies) int32."""
    if on_cpu(x):
        return lane_concat_plain(x, copies)
    require(x, torch.int32, "x", 2)
    out = torch.empty(x.shape[0], x.shape[1] * copies, dtype=torch.int32, device=x.device)
    _P6(x.data_ptr(), x.shape[0], x.shape[1], copies, out.data_ptr(), stream_ptr(x.device))
    lane_concat.launches += 1
    return out


def empty(device) -> None:
    """The launch floor: one empty kernel (one block of 32 threads) on the
    current stream of `device` (a CUDA device; "cuda" means the current
    one).  It computes nothing and counts nothing."""
    index = torch.device(device).index
    _EMPTY(stream_ptr(torch.device("cuda", torch.cuda.current_device() if index is None
                                   else index)))


dim0_dot.launches = 0
dma_1d.launches = 0
flatten.launches = 0
dma_3d.launches = 0
lane_write.launches = 0
lane_concat.launches = 0
flatten_big.launches = 0
