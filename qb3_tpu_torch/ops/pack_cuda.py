"""Wrappers of the CUDA kernels K1 (group pack) and K3 (window copy), with
their plain PyTorch twins and launch counters.

Counterpart of qb3_tpu/ops/pack_pallas.py.  A wrapper takes its plain twin
for a CPU tensor and launches its kernel (csrc/pack.cu) for a CUDA tensor;
there is no fallback from one to the other.  Each wrapper's ``launches``
attribute counts its kernel launches.
"""

from __future__ import annotations

import numpy as np
import torch

from .bitpack import group_offsets, pack_groups


def on_cpu(x) -> bool:
    """True for a CPU tensor (take the twin), False for a CUDA tensor
    (launch the kernel); raises for any other device."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return x.device.type == "cpu"


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
    return torch.cuda.current_stream(device).cuda_stream


def pack_groups_chunked(codes, lens, n_words: int, max_group_bits: int):
    """K1: encode phase B.  codes (..., ngroups, S) int64 bit patterns, lens
    (..., ngroups, S) int32 -> (words (..., n_words) int32 u32 patterns,
    total bits (...) int64, glen (..., ngroups) int32); leading axes are
    independent tiles.  max_group_bits sizes the twin's slabs; the kernel
    needs no bound."""
    if on_cpu(codes):
        return pack_groups(codes, lens, n_words, max_group_bits)
    from .. import _build

    require(codes, torch.int64, "codes")
    require(lens, torch.int32, "lens", codes.dim(), codes.device)
    if lens.shape != codes.shape:
        raise ValueError("codes and lens shapes differ")
    *lead, ngroups, S = codes.shape
    ntiles = int(np.prod(lead, dtype=np.int64))
    glen, goff, total = group_offsets(lens)
    goff = goff.contiguous()
    out = torch.zeros(*lead, n_words, dtype=torch.int32, device=codes.device)
    err = _build.load().qb3_pack_groups(
        codes.data_ptr(), lens.data_ptr(), goff.data_ptr(), ntiles * ngroups, S,
        ngroups, n_words, out.data_ptr(), stream_ptr(codes.device))
    _build.check(err, "qb3_pack_groups")
    pack_groups_chunked.launches += 1
    return out, total, glen.to(torch.int32)


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
    -> (n_tiles, R) int32."""
    if R % 128:
        raise ValueError(f"R={R} is not a multiple of 128")
    if on_cpu(words32):
        return extract_windows_plain(words32, wrow, R)
    from .. import _build

    require(words32, torch.int32, "words32", 1)
    require(wrow, torch.int32, "wrow", 1, words32.device)
    if words32.data_ptr() % 16:
        raise ValueError("words32 must be 16-byte aligned")
    out = torch.empty(wrow.shape[0], R, dtype=torch.int32, device=words32.device)
    err = _build.load().qb3_extract_windows(
        words32.data_ptr(), words32.shape[0], wrow.data_ptr(), wrow.shape[0], R,
        out.data_ptr(), stream_ptr(words32.device))
    _build.check(err, "qb3_extract_windows")
    extract_windows.launches += 1
    return out


extract_windows.launches = 0
