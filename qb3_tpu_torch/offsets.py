"""Serial offset recovery: the one inherently sequential piece of QB3 decode.

The bit position of group k+1 is unknown until group k's codes are measured
(SURVEY.md §3.3).  This module walks the stream once and records, for every
(block, band) group, where its value codes start and how to decode them; the
actual value decoding then runs fully parallel on device (ops/decode.py).

A copy of qb3_tpu/offsets.py (which needs no JAX), best-mode kinds
included, so that the PyTorch port never imports the JAX package.  A native
C++ port of this walk provides the fast path (native/qb3xs.cpp, built and
bound by native.py); this Python implementation is the portable reference.
Streams produced with the optional "ic" or "ix" sidecar skip the walk
entirely for FTL/BASE.

Group kinds:
  0 NORMAL     value codes at vrung (step restore if not FTL)
  1 ZERO       all-zero group, no value bits
  2 BITS       16 single-bit values (bitsused == 1)
  3 CF         divided group at vrung, multiplied back by cf
  4 CF0        16 single-bit selectors of +/-cf (trung == 0)
  5 IDX        16 rung-2 index codes then uniques at vrung
"""

from __future__ import annotations

import numpy as np

from . import tables as T
from .constants import B2, Mode, ubits_for

KIND_NORMAL, KIND_ZERO, KIND_BITS, KIND_CF, KIND_CF0, KIND_IDX = range(6)

# python-native tables for the serial walk
_DSW = {u: [(int(l), int(d)) for l, d in T.DSW[u, : 1 << (u + 1)]] for u in (3, 4, 5, 6)}
_DEC_GROUP = [[(int(l), int(v)) for l, v in T.DEC_GROUP[r, : 1 << (r + 2)]] for r in range(8)]
_DEC_SINGLE = [[(int(l), int(v)) for l, v in T.DEC_SINGLE[r, : 1 << (r + 2)]] for r in range(8)]
_IDX_DEC = [(int(l), int(v)) for l, v in T.IDX_DEC[: 16]]


def _qb3dsz(w: int, rung: int):
    """Computed decode for rung >= 2 (QB3decode.h:119-129); returns (len, val).
    May return len 65 at rung 63 (the caller reads the extra bit)."""
    rbit = 1 << rung
    if not w & 1:
        return rung, (w & (rbit - 1)) >> 1
    n = (w >> 1) & 1
    v = (w >> 2) & (rbit - 1)
    if not n:
        return rung + 1, v | (rbit >> 1)
    return rung + 2, v | rbit


def _dec_single(w: int, rung: int):
    if rung <= 7:
        return _DEC_SINGLE[rung][w & ((1 << (rung + 2)) - 1)]
    return _qb3dsz(w, rung)


class _Bits:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def peek(self) -> int:
        byte = self.pos >> 3
        chunk = self.data[byte : byte + 9]
        return int.from_bytes(chunk, "little") >> (self.pos & 7)


def parse_offsets(payload: bytes, nblocks: int, nbands: int, tsize: int,
                  mode: int, entry_runbits=None, entry_cf=None,
                  start_bit: int = 0):
    """Walk the stream; returns dict of (nblocks, nbands) numpy arrays.

    Corruption is reported, not raised, mirroring the reference's `failed`
    accumulation (QB3decode.h:642,:665,:683,:703): the walk stops at the
    first impossible state, marks the remaining groups all-zero (partial
    output), and sets `failed`/`failed_group` in the result.  The caller
    applies the reference's end-of-stream rule (>7 leftover bits fail,
    QB3decode.h:411,:744; truncated input reads as zeros and is accepted)."""
    u = ubits_for(tsize)
    nmask = (1 << u) - 1
    lmask = (1 << (u + 1)) - 1
    dsw = _DSW[u]
    ftl = mode == Mode.FTL
    maxbits = 8 * tsize

    runbits = [0] * nbands if entry_runbits is None else [int(x) for x in entry_runbits]
    pcf = [0] * nbands if entry_cf is None else [int(x) for x in entry_cf]

    kind = np.zeros((nblocks, nbands), np.uint8)
    val_pos = np.zeros((nblocks, nbands), np.int64)
    vrung = np.zeros((nblocks, nbands), np.int32)
    cf_arr = np.zeros((nblocks, nbands), np.uint64)
    rung_arr = np.zeros((nblocks, nbands), np.int32)
    pcf_in = np.zeros((nblocks, nbands), np.uint64)   # pcf BEFORE the block
    block_start = np.zeros(nblocks, np.int64)         # bit pos of the block

    s = _Bits(payload)
    s.pos = start_bit  # streaming callers resume mid-payload

    def group_len_normal(rung: int) -> int:
        """Advance past a group's value codes at `rung`; return nothing."""
        if rung <= 7:
            tbl = _DEC_GROUP[rung]
            m = (1 << (rung + 2)) - 1
            for _ in range(B2):
                ln = tbl[s.peek() & m][0]
                s.pos += ln
        else:
            for _ in range(B2):
                ln, _v = _qb3dsz(s.peek(), rung)
                if ln > 64:  # rung 63 long: 65 bits total
                    s.pos += 65
                else:
                    s.pos += ln
        return 0

    def group_decode(rung: int) -> list[int]:
        """Decode a group's values (needed for CF runbits recomputation)."""
        out = []
        if rung <= 7:
            tbl = _DEC_GROUP[rung]
            m = (1 << (rung + 2)) - 1
            for _ in range(B2):
                ln, v = tbl[s.peek() & m]
                s.pos += ln
                out.append(v)
        else:
            for _ in range(B2):
                ln, v = _qb3dsz(s.peek(), rung)
                if ln > 64:
                    s.pos += 64
                    v |= (s.peek() & 1) << 62
                    s.pos += 1
                else:
                    s.pos += ln
                out.append(v)
        return out

    failed = False
    failed_group = -1
    for b in range(nblocks):
        block_start[b] = s.pos
        pcf_in[b] = pcf
        for c in range(nbands):
            if failed:
                break
            w = s.peek()
            if w & 1:
                cs_len, delta = dsw[(w >> 1) & lmask]
            else:
                cs_len, delta = 1, 0
            # FTL treats the long no-change form as a plain codeswitch
            # (decodeFTL has no extended encodings, QB3decode.h:293-412)
            signal = (not ftl) and (w & 1) and delta == 0 and cs_len == u + 2
            if not signal:
                rung = (runbits[c] + delta) & nmask
                runbits[c] = rung
                s.pos += cs_len
                rung_arr[b, c] = rung
                vrung[b, c] = rung
                if rung == 0:
                    flag = s.peek() & 1
                    s.pos += 1
                    val_pos[b, c] = s.pos
                    if flag:
                        kind[b, c] = KIND_BITS
                        s.pos += B2
                    else:
                        kind[b, c] = KIND_ZERO
                else:
                    kind[b, c] = KIND_NORMAL
                    val_pos[b, c] = s.pos
                    group_len_normal(rung)
                continue
            # ---- extended encodings (best modes), QB3decode.h:624-716
            s.pos += cs_len
            l2, d2 = dsw[s.peek() & lmask]  # flagless codeswitch
            rung = (runbits[c] + d2) & nmask
            s.pos += l2 - 1
            if rung != nmask:  # CF group
                cfrung = rung
                w = s.peek()
                diff = w & 1
                s.pos += 1
                if diff:
                    own = s.peek() & 1
                    s.pos += 1
                    if own:
                        l3, d3 = dsw[s.peek() & lmask]
                        cfrung = (rung + d3) & nmask
                        s.pos += l3 - 1
                        failed |= cfrung == rung  # QB3decode.h:665
                    ln, v = _dec_single(s.peek(), cfrung - (1 if own else 0))
                    s.pos += ln
                    pcf[c] = v + ((1 << cfrung) if own else 0)
                cf = pcf[c] + 2
                cf_arr[b, c] = cf
                vrung[b, c] = rung
                if rung == 0:
                    kind[b, c] = KIND_CF0
                    val_pos[b, c] = s.pos
                    s.pos += B2
                    runbits[c] = (2 * cf - 1).bit_length() - 1
                else:
                    kind[b, c] = KIND_CF
                    val_pos[b, c] = s.pos
                    vals = group_decode(rung)
                    # step restore on the divided group, then magsmul OR
                    acc = 0
                    for i, v in enumerate(vals):
                        acc |= ((v >> rung) & 1) << i
                    if acc & (acc + 1) == 0:  # 1*0* pattern (incl all-zero)
                        ones = acc.bit_length()
                        if ones < B2:
                            vals[ones] ^= 1 << rung
                    used = 0
                    for v in vals:
                        used |= ((v >> 1) + (v & 1)) * (cf << 1) - (v & 1) if v else 0
                    used &= (1 << maxbits) - 1
                    failed |= cf > used  # QB3decode.h:683
                    runbits[c] = max((used | 1).bit_length() - 1, 0)
                rung_arr[b, c] = runbits[c]
            else:  # index group
                l3, d3 = dsw[s.peek() & lmask]
                rung = (runbits[c] + d3) & nmask
                runbits[c] = rung
                s.pos += l3 - 1
                kind[b, c] = KIND_IDX
                vrung[b, c] = rung
                rung_arr[b, c] = rung
                val_pos[b, c] = s.pos
                failed |= rung == 63  # QB3decode.h:703 (u64 overflow guard)
                maxidx = 0
                idx_bits = 0
                for _ in range(B2):
                    ln, v = _IDX_DEC[s.peek() & 0xF]
                    s.pos += ln
                    idx_bits += ln
                    maxidx = max(maxidx, v)
                # max valid index section is 52 bits (QB3decode.h:707-713)
                failed |= idx_bits > 52
                for _ in range(maxidx + 1):
                    ln, _v = _dec_single(s.peek(), rung)
                    s.pos += ln
            if failed:
                failed_group = b * nbands + c
        if failed:
            break
    if failed:
        # best-effort partial output: remaining groups decode as zeros
        kind.reshape(-1)[failed_group + 1:] = KIND_ZERO
    return dict(kind=kind, val_pos=val_pos, vrung=vrung, cf=cf_arr, rung=rung_arr,
                pcf_in=pcf_in, block_start=block_start,
                end_pos=s.pos, failed=failed, failed_group=failed_group,
                exit_runbits=np.array(runbits, np.int32),
                exit_cf=np.array(pcf, np.uint64))
