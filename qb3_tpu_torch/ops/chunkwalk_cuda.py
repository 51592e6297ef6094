"""Wrapper of the CUDA kernel K2 (the "ic" chunk walk for u8/u16 streams),
its plain PyTorch twin, launch counter and host-side window sizing.

Counterpart of qb3_tpu/ops/chunkwalk_pallas.py.  The wrapper takes the twin
for a CPU tensor and launches csrc/chunkwalk.cu for a CUDA tensor; there is
no fallback from one to the other.  Both read each chunk's words from its
tile's window (tiles of 128 chunks, staged by K3) and from the stream itself
only where a corrupt chunk walks outside the window, so both equal the JAX
package's portable walk (decode_chunked) bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from .bitutils import M32, words_u32
from .decode_chunked import WINDOW_TILE, walk_chunks
from .pack_cuda import on_cpu, require, stream_ptr


def ic_maxw(spans: np.ndarray) -> int:
    """Window word count covering the widest chunk from any 32-bit phase
    (host side), bucketed."""
    m = int(spans.max()) if spans.size else 0
    w = m // 32 + 3
    return max(8, -(-w // 16) * 16)


def ic_window_R(starts: np.ndarray, maxw: int, G: int = WINDOW_TILE) -> int:
    """Window word count over chunk bases (host side): covers every G-chunk
    tile's span plus maxw slack, in whole 128-word rows."""
    base = np.asarray(starts, np.int64) >> 5
    n = base.shape[0]
    pad = (-n) % G
    if pad:
        base = np.concatenate([base, np.repeat(base[-1], pad)])
    first = (base[::G] >> 7) << 7  # 128-aligned window starts
    last = base[np.minimum(np.arange(first.size) * G + G - 1, base.size - 1)]
    R = int((last - first).max()) + maxw + 130
    return max(256, -(-R // 256) * 256)


def ic_walk_params(starts: np.ndarray, spans: np.ndarray):
    """(maxw, R) for the u8/u16 chunk walk over these chunk starts/spans,
    computed once on the host for decode_chunked_auto."""
    maxw = ic_maxw(spans)
    return maxw, ic_window_R(starts, maxw)


def chunkwalk8_plain(words32, win, wrow, starts, entry_rungs, K: int, NB: int,
                     apply_step: bool, ubits: int):
    """K2's twin: the same walk in plain PyTorch -> (nchunks, K, NB, 16)
    int32."""
    w = words_u32(words32)
    R = win.shape[1]
    winf = win.reshape(-1).to(torch.int64) & M32
    tile = torch.arange(starts.shape[0], device=starts.device) // WINDOW_TILE
    wbase = (wrow.to(torch.int64)[tile] * 128)[:, None]
    toff = (tile * R)[:, None]

    def read(idx):
        r = idx - wbase
        inw = (r >= 0) & (r < R)
        return torch.where(inw, winf[toff + torch.where(inw, r, 0)], w[idx])

    g = walk_chunks(read, w.shape[0], starts, entry_rungs, K, NB, apply_step,
                    8 if ubits == 3 else 16)
    return g.to(torch.int32)


def chunkwalk8(words32, win, wrow, starts, entry_rungs, K: int, NB: int,
               apply_step: bool, ubits: int):
    """K2: chunk-parallel u8 (ubits 3) / u16 (ubits 4) walk.

    words32 (n32,) int32 padded stream words; win (n_tiles, R) int32 tile
    windows from K3 with wrow (n_tiles,) int32 their row indices; starts
    (nchunks,) int32 absolute bit offsets; entry_rungs (nchunks, NB) int32
    -> (nchunks, K, NB, 16) int32 mag-sign values.
    """
    if ubits not in (3, 4):
        raise ValueError(f"ubits {ubits}: the chunk walk kernel covers u8/u16")
    if on_cpu(words32):
        return chunkwalk8_plain(words32, win, wrow, starts, entry_rungs, K, NB,
                                apply_step, ubits)
    from .. import _build

    dev = words32.device
    require(words32, torch.int32, "words32", 1)
    require(win, torch.int32, "win", 2, dev)
    require(wrow, torch.int32, "wrow", 1, dev)
    require(starts, torch.int32, "starts", 1, dev)
    require(entry_rungs, torch.int32, "entry_rungs", 2, dev)
    nchunks = starts.shape[0]
    if entry_rungs.shape != (nchunks, NB) or wrow.shape[0] * WINDOW_TILE < nchunks:
        raise ValueError("chunk walk arguments disagree in shape")
    out = torch.empty(nchunks, K, NB, 16, dtype=torch.int32, device=dev)
    err = _build.load().qb3_chunkwalk(
        words32.data_ptr(), words32.shape[0], win.data_ptr(), wrow.data_ptr(),
        win.shape[1], starts.data_ptr(), entry_rungs.data_ptr(), nchunks, K, NB,
        int(apply_step), ubits, out.data_ptr(), stream_ptr(dev))
    _build.check(err, "qb3_chunkwalk")
    chunkwalk8.launches += 1
    return out


chunkwalk8.launches = 0
