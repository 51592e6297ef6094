"""Wrappers of the CUDA kernels K1 (group pack) and K3 (window copy), with
their plain PyTorch twins and launch counters.

Counterpart of qb3_tpu/ops/pack_pallas.py.  A wrapper takes its plain twin
for a CPU tensor and launches its kernel (csrc/pack.cu) for a CUDA tensor;
there is no fallback from one to the other.  Each wrapper's ``launches``
attribute counts its kernel launches.
"""

from __future__ import annotations

import math

import torch

from .. import _build
from .bitpack import pack_groups

_K1 = _build.Kernel("qb3_pack_groups")
_K3 = _build.Kernel("qb3_extract_windows")

PACK_G = 128  # groups a K1 block packs, and a K8 block at most (csrc/pack.cu kGroups)
PACK_MAX_S = 64  # symbols a group at most (csrc/pack.cu kMaxSymbols)


def on_cpu(x) -> bool:
    """True for a CPU tensor (take the twin), False for a CUDA tensor
    (launch the kernel); raises for any other device.  (is_cuda and is_cpu
    cost a fraction of device.type, which builds a string.)"""
    if x.is_cuda:
        return False
    if x.is_cpu:
        return True
    raise ValueError(f"unsupported device {x.device}")


def require(x, dtype, name: str, ndim: int | None = None, device=None):
    """Validate a kernel argument: dtype, contiguity, rank, device."""
    if x.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if ndim is not None and x.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(x.shape)}")
    if device is not None and x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")


def stream_ptr(device) -> int:
    """The raw handle of the current stream of a tensor's device, without
    building a Python Stream object: PyTorch's private call, the one
    Triton's launcher takes."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def _strides(shape) -> tuple:
    """A contiguous tensor's strides."""
    out, n = [], 1
    for d in reversed(shape):
        out.append(n)
        n *= d
    return tuple(reversed(out))


def pack_buffers(lead, ngroups: int, n_words: int, nblocks: int, device):
    """One allocation for what a pack kernel (K1, K8) writes, in 8-byte
    units: words (*lead, n_words) int32, total (*lead) int64, then the
    look-back's ticket and nblocks state words, which the kernel's memset
    zeroes with the words and totals, then glen (*lead, ngroups) int32.
    Returns (words, total, glen, the C entry point's pointer arguments: out,
    total, glen, scratch, zero_bytes).  The outputs are strided views of the
    one buffer (cheaper on the host than slices and reshapes)."""
    lead = tuple(lead)
    ntiles = math.prod(lead)
    w_end = (ntiles * n_words + 1) // 2
    t_end = w_end + ntiles
    z_end = t_end + 1 + nblocks
    buf = torch.empty(z_end + (ntiles * ngroups + 1) // 2, dtype=torch.int64, device=device)
    b32 = buf.view(torch.int32)
    words = b32.as_strided((*lead, n_words), _strides((*lead, n_words)), 0)
    total = buf.as_strided(lead, _strides(lead), w_end)
    glen = b32.as_strided((*lead, ngroups), _strides((*lead, ngroups)), 2 * z_end)
    ptr = buf.data_ptr()
    return words, total, glen, (ptr, ptr + 8 * w_end, ptr + 8 * z_end, ptr + 8 * t_end, 8 * z_end)


def pack_groups_chunked(codes, lens, n_words: int, max_group_bits: int):
    """K1: encode phase B.  codes (..., ngroups, S) int64 bit patterns, lens
    (..., ngroups, S) int32 -> (words (..., n_words) int32 u32 patterns,
    total bits (...) int64, glen (..., ngroups) int32); leading axes are
    independent tiles.  max_group_bits sizes the twin's slabs; the kernel
    needs no bound.  One memset and one launch: the kernel scans the group
    lengths itself.  Lengths outside [0, 64] are the twin's undefined
    inputs; the kernel clamps them into it."""
    if on_cpu(codes):
        return pack_groups(codes, lens, n_words, max_group_bits)
    require(codes, torch.int64, "codes")
    require(lens, torch.int32, "lens", codes.dim(), codes.device)
    if lens.shape != codes.shape:
        raise ValueError("codes and lens shapes differ")
    *lead, ngroups, S = codes.shape
    if not 1 <= S <= PACK_MAX_S:
        raise ValueError(f"{S} symbols a group: the kernel takes 1 to {PACK_MAX_S}")
    ntiles = math.prod(lead)
    nblocks = ntiles * -(-ngroups // PACK_G)
    words, total, glen, ptrs = pack_buffers(lead, ngroups, n_words, nblocks, codes.device)
    _K1(codes.data_ptr(), lens.data_ptr(), ntiles, ngroups, S, n_words, *ptrs, nblocks,
        stream_ptr(codes.device))
    pack_groups_chunked.launches += 1
    return words, total, glen


pack_groups_chunked.launches = 0


def extract_windows_plain(words32, wrow, R: int):
    """K3's twin: out[t, j] = words32[wrow[t] * 128 + j] for j < R, zero
    past the end of the stream."""
    idx = wrow.to(torch.int64)[:, None] * 128 + torch.arange(R, device=words32.device)
    live = (idx >= 0) & (idx < words32.shape[0])
    return torch.where(live, words32[torch.where(live, idx, 0)], 0)


def extract_windows(words32, wrow, R: int):
    """K3: per-tile stream windows.  words32 (n,) int32 u32 patterns, wrow
    (n_tiles,) int32 row indices (rows of 128 words), R a multiple of 128
    -> (n_tiles, R) int32.  No window, no launch."""
    if R % 128:
        raise ValueError(f"R={R} is not a multiple of 128")
    if on_cpu(words32):
        return extract_windows_plain(words32, wrow, R)
    dev = words32.device
    require(words32, torch.int32, "words32", 1)
    require(wrow, torch.int32, "wrow", 1, dev)
    ptr = words32.data_ptr()
    if ptr % 16:
        raise ValueError("words32 must be 16-byte aligned")
    n_tiles = wrow.shape[0]
    out = torch.empty(n_tiles, R, dtype=torch.int32, device=dev)
    if n_tiles and R:
        _K3(ptr, words32.shape[0], wrow.data_ptr(), n_tiles, R, out.data_ptr(), stream_ptr(dev))
        extract_windows.launches += 1
    return out


extract_windows.launches = 0
