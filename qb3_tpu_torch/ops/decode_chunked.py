"""Self-contained parallel decode from the compact "ic" chunked index.

PyTorch counterpart of the "ic" half of qb3_tpu/ops/decode_chunked.py.  The
"ic" chunk anchors every K blocks: a bit span per chunk plus the per-band
entry rung state (and, for best-mode streams, the per-band previous CF).
Decode runs chunk-parallel: every chunk walks its K blocks at once; within
a chunk the groups decode in order, which is the serial dependency the
reference decoder has (QB3decode.h:603-723) carried by one lane per chunk.
Any dtype.

decode_chunked_auto runs u8/u16 FTL/BASE streams through the window copy K3
and the chunk walk K2 (chunkwalk_cuda.py) and wider types through the
PyTorch walk :func:`decode_chunked`; best-mode streams take the PyTorch walk
:func:`decode_chunked_best`, as qb3_tpu computes it outside any Pallas
kernel.  Each runs on whatever device the tensors are on.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import B2
from .bitutils import magsmul, srl, topbit, words_u32, wrap
from .decode import (_vlc_decode_arith, _vlc_decode_plain, _vlc_decode_single, dsw_arith,
                     step_restore, window64)

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
    if k < 1 or head & _IC_BEST:  # best-mode anchors: parse_ic_best
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


def parse_ic_best(buf: bytes, nblocks: int, nbands: int):
    """The best modes' "ic" payload (qb3_tpu's parse_ic_best): parse_ic's
    plus per-chunk per-band u16le entry pcf -> (k_blocks, starts, entry
    rungs, entry pcf (nchunks, nbands) int64, total_bits), or None if
    inconsistent."""
    if len(buf) < 2:
        return None
    head = int.from_bytes(buf[:2], "little")
    if not head & _IC_BEST:
        return None
    k = head & ~(_IC_WIDE | _IC_BEST)
    wide = bool(head & _IC_WIDE)
    if k < 1:
        return None
    nchunks = -(-nblocks // k)
    sbytes = 4 if wide else 2
    if len(buf) != 2 + nchunks * (sbytes + 3 * nbands):
        return None
    spans = np.frombuffer(buf, dtype="<u4" if wide else "<u2",
                          count=nchunks, offset=2).astype(np.int64)
    off = 2 + sbytes * nchunks
    entry = np.frombuffer(buf, dtype=np.uint8, count=nchunks * nbands,
                          offset=off).reshape(nchunks, nbands)
    pcf = np.frombuffer(buf, dtype="<u2", count=nchunks * nbands,
                        offset=off + nchunks * nbands).reshape(nchunks, nbands)
    ends = np.cumsum(spans)
    starts = ends - spans
    if ends[-1] >= 1 << 31:
        return None
    return k, starts, entry.astype(np.int32), pcf.astype(np.int64), int(ends[-1])


def pack_ic_best(spans: np.ndarray, entry: np.ndarray, pcf: np.ndarray,
                 k_blocks: int) -> bytes:
    """The best modes' "ic" payload: pack_ic's plus per-chunk per-band u16le
    entry pcf (biased CF, cf - 2).  Callers check pcf <= 0xFFFF
    (chunk_spans_best; wider CFs take the "ib" sidecar)."""
    wide = spans.size and int(spans.max()) > 0xFFFF
    head = int(k_blocks) | _IC_BEST | (_IC_WIDE if wide else 0)
    return (head.to_bytes(2, "little")
            + spans.astype("<u4" if wide else "<u2").tobytes()
            + entry.astype(np.uint8).tobytes()
            + pcf.astype("<u2").tobytes())


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


def chunk_spans_best(glens: np.ndarray, rungs: np.ndarray, pcf_in: np.ndarray,
                     entry_runbits: np.ndarray, entry_cf: np.ndarray, k_blocks: int):
    """Host-side pieces of the best modes' "ic" payload.

    rungs: (nblocks, nbands) runbits a decoder holds after each block
    (encode_best_blocks' post_runbits); pcf_in: (nblocks, nbands) biased CF
    state before each block.  Returns (spans u32, entry u8, pcf int64), or
    None when a pcf passes 16 bits."""
    spans, entry = chunk_spans(glens, rungs, entry_runbits, k_blocks)
    nchunks, nbands = spans.shape[0], rungs.shape[1]
    pcf = np.empty((nchunks, nbands), np.int64)
    pcf[0] = entry_cf
    pcf[1:] = pcf_in[k_blocks: (nchunks - 1) * k_blocks + 1: k_blocks]
    if pcf.size and int(pcf.max()) > 0xFFFF:
        return None
    return spans, entry, pcf


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
    reg_idx = torch.arange(NREG, device=dev)

    def group_step(off, rung_band):
        off64 = off.to(torch.int64)
        base = (off64 >> 5).clamp(0, n32 - NREG)
        phase = off64 - (base << 5)  # == off & 31 except in the clipped tail
        regs = read(base[:, None] + reg_idx)
        regs = torch.cat([regs, torch.zeros_like(regs[:, :2])], dim=1)

        def window(o):
            return window64(regs, o)

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
            g = step_restore(g, rung, is_group)
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


# -------------------------------------------------- best-mode chunk walk

# register window sizes covering one best-mode group's worst span (the
# SIGNAL prefix, CF header, 16 values and 8 uniques) from any 32-bit phase
_NREG_BEST = {8: 10, 16: 17, 32: 29, 64: 53}


def decode_chunked_best(words32, starts, entry_rungs, entry_pcf, k_blocks: int,
                        nblocks: int, nbands: int, tbits: int):
    """Chunk-parallel walk of CF / index (best-mode) streams -> final
    mag-sign groups (nblocks*nbands, B2) int64; reconstruct needs no kind.

    The counterpart of qb3_tpu's decode_chunked_best, the same loop over a
    chunk's k_blocks x nbands groups as walk_chunks with the extended
    encodings (QB3decode.h:624-716): SIGNAL codeswitch detection, CF groups
    (a second flagless codeswitch, the optional own-rung CF code, the
    per-band pcf chain, the multiply-back, runbits recomputed from the
    restored group), CF0 expansion and index groups (16 rung-2 indices, then
    the uniques).  The step restore (best modes scan like BASE) runs here.

    words32: padded stream words (int32 u32 patterns, or int64 u64 words);
    starts: (nchunks,) int32 bit offset of each chunk; entry_rungs,
    entry_pcf: (nchunks, nbands) runbits and biased CF (cf - 2) at each
    chunk's entry.
    """
    ubits = {8: 3, 16: 4, 32: 5, 64: 6}[tbits]
    nmask = (1 << ubits) - 1
    NREG = _NREG_BEST[tbits]
    per = _PER[tbits]
    words = words_u32(words32)
    n32 = words.shape[0]
    dev = starts.device
    reg_idx = torch.arange(NREG, device=dev)

    def group_step(off, rung_band, pcf_band):
        off64 = off.to(torch.int64)
        base = (off64 >> 5).clamp(0, n32 - NREG)
        phase = off64 - (base << 5)
        regs = words[base[:, None] + reg_idx]
        regs = torch.cat([regs, torch.zeros_like(regs[:, :2])], dim=1)

        def window(o):
            return window64(regs, o)

        # ---- codeswitch parse and SIGNAL detection (QB3decode.h:613-624)
        w0 = window(phase)
        has_cs = (w0 & 1) == 1
        dlen, ddelta = dsw_arith(srl(w0, 1), ubits)
        cs_len = torch.where(has_cs, dlen, 1)
        delta = torch.where(has_cs, ddelta, 0)
        signal = has_cs & (delta == 0) & (cs_len == ubits + 2)
        o = phase + cs_len

        # ---- the plain path (no SIGNAL)
        rung_p = (rung_band + delta) & nmask
        rung0 = rung_p == 0
        w1 = window(o)
        flagbit = w1 & 1
        is_bits = ~signal & rung0 & (flagbit == 1)
        is_norm = ~signal & ~rung0

        # ---- the extended prefix: a flagless codeswitch at o
        l2, d2 = dsw_arith(w1, ubits)
        rung_x = (rung_band + d2) & nmask
        o_x = o + torch.where(signal, l2 - 1, 0)
        is_cfk = signal & (rung_x != nmask)
        is_idxk = signal & (rung_x == nmask)

        # ---- the CF header (QB3decode.h:640-668)
        wcf = window(o_x)
        diff = wcf & 1
        take_own = is_cfk & (diff == 1) & ((srl(wcf, 1) & 1) == 1)
        o_cf = o_x + torch.where(is_cfk, 1 + diff, 0)
        l3, d3 = dsw_arith(window(o_cf), ubits)
        cfrung = torch.where(take_own, (rung_x + d3) & nmask, rung_x)
        o_cf = o_cf + torch.where(take_own, l3 - 1, 0)
        # the cf value at cfrung (cfrung - 1, the top bit implied, when own)
        cv, cl = _vlc_decode_single(window(o_cf), torch.where(take_own, cfrung - 1, cfrung))
        cv = cv + torch.where(take_own, 1 << cfrung, 0)
        has_diff = is_cfk & (diff == 1)
        o_cf = o_cf + torch.where(has_diff, cl, 0)
        pcf_new = torch.where(has_diff, cv, pcf_band)
        cf = pcf_new + 2
        cf0 = is_cfk & (rung_x == 0)
        cfg = is_cfk & (rung_x != 0)

        # ---- the index prefix: a third codeswitch gives the value rung
        l4, d4 = dsw_arith(wcf, ubits)
        rung_i = (rung_band + d4) & nmask
        o_i = o_x + torch.where(is_idxk, l4 - 1, 0)

        # ---- one value walk serves every kind: the rung and how values
        # decode differ per chunk, taken by selects
        vrung = torch.where(is_norm, rung_p, torch.where(cfg, rung_x, torch.where(
            is_idxk, 2, rung_p)))
        one_bit = is_bits | cf0  # 16 literal bits
        o_v = torch.where(is_cfk, o_cf, torch.where(is_idxk, o_i, o + rung0.to(torch.int64)))
        group_like = is_norm | cfg  # group-context VLC at vrung
        two = torch.full_like(vrung, 2)
        outs = []
        for v0 in range(0, B2, per):
            w = window(o_v)
            shift = torch.zeros_like(o_v)
            for _ in range(min(per, B2 - v0)):
                ww = srl(w, shift)
                gv, gl = _vlc_decode_arith(ww, vrung)
                iv, il = _vlc_decode_plain(ww, two)
                if tbits == 64:
                    # rung-63 long form: bit 62 of the value is the stream bit
                    # right after the 64-bit code part
                    extra = window(o_v + shift + 64) & 1
                    gv = gv | torch.where((gl == 65) & group_like, extra << 62, 0)
                outs.append(torch.where(group_like, gv, torch.where(
                    is_idxk, iv, torch.where(one_bit, ww & 1, 0))))
                shift = shift + torch.where(group_like, gl, torch.where(
                    is_idxk, il, one_bit.to(torch.int64)))
            o_v = o_v + shift
        g = torch.stack(outs, dim=-1)  # (nchunks, B2)

        # ---- index uniques (QB3decode.h:681-716)
        maxidx = torch.where(is_idxk[:, None], g, 0).amax(-1)
        uniqs = []
        for u in range(B2 // 2):
            live = is_idxk & (u <= maxidx)
            uv, ul = _vlc_decode_single(window(o_v), rung_i)
            o_v = o_v + torch.where(live, ul, 0)
            uniqs.append(torch.where(live, uv, 0))
        uq = torch.stack(uniqs, dim=-1)  # (nchunks, 8)
        g = torch.where(is_idxk[:, None], uq.gather(1, g.clamp(0, B2 // 2 - 1)), g)

        # ---- step restore, then the CF multiply-back and the CF0 expansion,
        # masked to the width
        g = step_restore(g, vrung, is_norm | cfg)
        g = torch.where(cfg[:, None], magsmul(g, cf[:, None], tbits), g)
        neg = wrap(((cf - 1) << 1) | 1, tbits)
        g = torch.where(cf0[:, None], torch.where(g != 0, neg[:, None], 0), g)

        # ---- the runbits after the group (the decoder's recompute,
        # QB3decode.h:664)
        used = g[:, 0]
        for i in range(1, B2):
            used = used | g[:, i]
        post = torch.where(is_idxk, rung_i, torch.where(cfg, topbit(used | 1), torch.where(
            cf0, topbit((2 * cf - 1) | 1), rung_p)))
        new_pcf = torch.where(has_diff, pcf_new, pcf_band)
        end = torch.where(~signal & rung0, o + 1 + torch.where(is_bits, B2, 0), o_v)
        return g, (off64 + (end - phase)).to(torch.int32), post, new_pcf

    off = starts.to(torch.int32)
    rungs = [entry_rungs[:, b].to(torch.int64) for b in range(nbands)]
    pcfs = [entry_pcf[:, b].to(torch.int64) for b in range(nbands)]
    blocks = []
    for _ in range(k_blocks):
        gs = []
        for b in range(nbands):
            g, off, rungs[b], pcfs[b] = group_step(off, rungs[b], pcfs[b])
            gs.append(g)
        blocks.append(torch.stack(gs, dim=1))  # (nchunks, nbands, B2)
    g = torch.stack(blocks, dim=1).reshape(-1, nbands, B2)[:nblocks]
    return g.reshape(nblocks * nbands, B2)
