"""Self-contained parallel decode from the compact "ic" chunked index.

PyTorch counterpart of the "ic" half of qb3_tpu/ops/decode_chunked.py.  The
"ic" chunk anchors every K blocks: a bit span per chunk plus the per-band
entry rung state.  Decode runs chunk-parallel: every chunk walks its K
blocks at once; within a chunk the groups decode in order, which is the
serial dependency the reference decoder has (QB3decode.h:603-723) carried by
one lane per chunk.  FTL/BASE streams only, any dtype.

decode_chunked_auto runs u8/u16 streams through the window copy K3 and the
chunk walk K2 (chunkwalk_cuda.py) and wider types through the PyTorch walk
:func:`decode_chunked`, on whatever device the tensors are on.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import B2
from .bitutils import srl, step_flip_index, words_u32
from .decode import _vlc_decode_arith, dsw_arith

# static register-window sizes per element width: cover one group's worst
# span (prefix + 16 codes [+ overflow bits]) from any 32-bit phase
_NREG = {8: 7, 16: 11, 32: 20, 64: 36}
# values decoded per 64-bit window (per * max_code_bits <= 64)
_PER = {8: 6, 16: 3, 32: 1, 64: 1}

IC_DEFAULT_K = 8  # blocks per chunk
_IC_WIDE = 0x8000  # k_blocks flag: u32 spans (chunk spans can exceed 65535)
_IC_BEST = 0x4000  # k_blocks flag: best-mode anchors (adds per-band pcf)
WINDOW_TILE = 128  # chunks per K3 window tile


def pack_ic(spans: np.ndarray, entry: np.ndarray, k_blocks: int) -> bytes:
    """Serialize the "ic" chunk payload: u16le k_blocks (bit 15 set when the
    spans need u32), per-chunk u16le/u32le bit spans, then per-chunk
    per-band entry rung bytes."""
    wide = spans.size and int(spans.max()) > 0xFFFF
    head = int(k_blocks) | (_IC_WIDE if wide else 0)
    return (head.to_bytes(2, "little")
            + spans.astype("<u4" if wide else "<u2").tobytes()
            + entry.astype(np.uint8).tobytes())


def parse_ic(buf: bytes, nblocks: int, nbands: int):
    """Inverse of pack_ic -> (k_blocks, starts int64 (nchunks,),
    entry (nchunks, nbands) int32, total_bits), or None if inconsistent."""
    if len(buf) < 2:
        return None
    head = int.from_bytes(buf[:2], "little")
    k = head & ~(_IC_WIDE | _IC_BEST)
    wide = bool(head & _IC_WIDE)
    if k < 1 or head & _IC_BEST:  # best-mode anchors are not ported
        return None
    nchunks = -(-nblocks // k)
    sbytes = 4 if wide else 2
    if len(buf) != 2 + nchunks * (sbytes + nbands):
        return None
    spans = np.frombuffer(buf, dtype="<u4" if wide else "<u2",
                          count=nchunks, offset=2).astype(np.int64)
    entry = np.frombuffer(buf, dtype=np.uint8,
                          offset=2 + sbytes * nchunks).reshape(nchunks, nbands)
    ends = np.cumsum(spans)
    starts = ends - spans
    if ends[-1] >= 1 << 31:  # int32 bit cursors in the device walk
        return None
    return k, starts, entry.astype(np.int32), int(ends[-1])


def chunk_spans(glens: np.ndarray, rungs: np.ndarray, entry_runbits: np.ndarray,
                k_blocks: int):
    """Host-side "ic" payload pieces from the encoder's per-group lengths and
    per-block rung tensor.

    glens: (nblocks*nbands,) bit length per group in stream order;
    rungs: (nblocks, nbands) running runbits state AFTER each block;
    entry_runbits: (nbands,) state before the image.
    Returns (spans u32 (nchunks,), entry (nchunks, nbands) u8).
    """
    nblocks, nbands = rungs.shape
    nchunks = -(-nblocks // k_blocks)
    g = np.zeros(nchunks * k_blocks * nbands, np.int64)
    g[: glens.size] = glens
    spans = g.reshape(nchunks, -1).sum(axis=1).astype(np.uint32)
    entry = np.empty((nchunks, nbands), np.uint8)
    entry[0] = entry_runbits
    entry[1:] = rungs[k_blocks - 1 : (nchunks - 1) * k_blocks : k_blocks]
    return spans, entry


def walk_chunks(read, n32: int, starts, entry_rungs, k_blocks: int, nbands: int,
                apply_step: bool, tbits: int):
    """The chunk-parallel walk -> (nchunks, K, NB, B2) int64 mag-sign values.

    read(idx) returns the u32 stream words (as int64) at int64 word indices
    idx, all in [0, n32).  starts: (nchunks,) int32 absolute bit offset of
    each chunk; entry_rungs: (nchunks, nbands) runbits at each chunk entry.
    Each group reads NREG words from its clipped base word and decodes from
    64-bit windows of that register set, exactly as the JAX package's walk.
    """
    ubits = {8: 3, 16: 4, 32: 5, 64: 6}[tbits]
    nmask = (1 << ubits) - 1
    NREG = _NREG[tbits]
    per = _PER[tbits]
    dev = starts.device
    lane = torch.arange(B2, device=dev)
    reg_idx = torch.arange(NREG, device=dev)

    def group_step(off, rung_band):
        off64 = off.to(torch.int64)
        base = (off64 >> 5).clamp(0, n32 - NREG)
        phase = off64 - (base << 5)  # == off & 31 except in the clipped tail
        regs = read(base[:, None] + reg_idx)
        regs = torch.cat([regs, torch.zeros_like(regs[:, :2])], dim=1)

        def window(o):
            """64 stream bits at register-set offset o; word indices outside
            [0, NREG-1] read as NREG-1 (the JAX select chain's default)."""
            wi = o >> 5
            wi = torch.where((wi < 0) | (wi > NREG - 1), NREG - 1, wi)[:, None]
            sh = o & 31
            lo = (regs.gather(1, wi) | (regs.gather(1, wi + 1) << 32))[:, 0]
            w2 = regs.gather(1, wi + 2)[:, 0]
            return srl(lo, sh) | torch.where(sh == 0, 0, w2 << ((64 - sh) & 63))

        # ---- codeswitch parse (QB3decode.h:613-618)
        w0 = window(phase)
        has_cs = (w0 & 1) == 1
        dlen, ddelta = dsw_arith(srl(w0, 1), ubits)
        cs_len = torch.where(has_cs, dlen, 1)
        delta = torch.where(has_cs, ddelta, 0)
        rung = (rung_band + delta) & nmask
        rung0 = rung == 0
        is_bits = rung0 & (((w0 >> cs_len) & 1) == 1)
        is_group = ~rung0
        o = phase + cs_len + rung0.to(torch.int64)

        # ---- 16-value wavefront, `per` values per 64-bit window
        outs = []
        for v0 in range(0, B2, per):
            w = window(o)
            shift = torch.zeros_like(o)
            for _ in range(min(per, B2 - v0)):
                ww = srl(w, shift)
                gv, gl = _vlc_decode_arith(ww, rung)
                if tbits == 64:
                    # rung-63 long form: 65 bits, bit 62 of the value is the
                    # stream bit right after the 64-bit code part
                    extra = window(o + shift + 64) & 1
                    gv = gv | torch.where((gl == 65) & is_group, extra << 62, 0)
                outs.append(torch.where(is_group, gv, torch.where(is_bits, ww & 1, 0)))
                shift = shift + torch.where(is_group, gl, is_bits.to(torch.int64))
            o = o + shift
        g = torch.stack(outs, dim=-1)  # (nchunks, B2)

        if apply_step:
            match, ones = step_flip_index(g, rung)
            do = is_group & match & (rung >= 1)
            flip = do[:, None] & (lane == ones[:, None]) & (ones[:, None] < B2)
            g = g ^ (flip.to(torch.int64) << rung[:, None])
        return g, (off64 + (o - phase)).to(torch.int32), rung

    off = starts.to(torch.int32)
    rungs = [entry_rungs[:, b].to(torch.int64) for b in range(nbands)]
    blocks = []
    for _ in range(k_blocks):
        gs = []
        for b in range(nbands):
            g, off, rungs[b] = group_step(off, rungs[b])
            gs.append(g)
        blocks.append(torch.stack(gs, dim=1))  # (nchunks, nbands, B2)
    return torch.stack(blocks, dim=1)


def decode_chunked(words32, starts, entry_rungs, k_blocks: int, nblocks: int,
                   nbands: int, apply_step: bool, tbits: int):
    """Chunk-parallel decode reading the stream directly -> mag-sign groups
    (nblocks*nbands, B2) int64.

    words32: padded stream words (int32 u32 patterns, or int64 u64 words);
    starts: (nchunks,) int32 absolute bit offset of each chunk;
    entry_rungs: (nchunks, nbands) int32 runbits state at each chunk entry.
    """
    w = words_u32(words32)
    g = walk_chunks(lambda idx: w[idx], w.shape[0], starts, entry_rungs,
                    k_blocks, nbands, apply_step, tbits)
    return g.reshape(-1, nbands, B2)[:nblocks].reshape(nblocks * nbands, B2)


def decode_chunked_auto(words32, starts, entry_rungs, k_blocks: int,
                        nblocks: int, nbands: int, apply_step: bool,
                        tbits: int, maxw: int | None = None, R: int | None = None):
    """Dispatch the chunk walk by element width: u8/u16 through K3 + K2
    (their wrappers launch the CUDA kernels on a CUDA tensor and take the
    plain twins on a CPU tensor), u32/u64 through :func:`decode_chunked`.

    words32 (n32,) int32; maxw and R come from ic_walk_params over the same
    starts (required for u8/u16).  Returns (nblocks*nbands, B2) int64.
    """
    if tbits > 16:
        return decode_chunked(words32, starts, entry_rungs, k_blocks, nblocks,
                              nbands, apply_step, tbits)
    from .chunkwalk_cuda import chunkwalk8
    from .pack_cuda import extract_windows

    if maxw is None or R is None or R % 128 or R < maxw:
        raise ValueError(f"bad chunk-walk window sizes maxw={maxw} R={R}")
    wrow = (starts[::WINDOW_TILE] >> 5) >> 7
    win = extract_windows(words32, wrow, R)
    g = chunkwalk8(words32, win, wrow, starts, entry_rungs, k_blocks, nbands,
                   apply_step, 3 if tbits == 8 else 4)
    g = g.to(torch.int64).reshape(-1, nbands, B2)[:nblocks]
    return g.reshape(nblocks * nbands, B2)
