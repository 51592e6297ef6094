"""QB3 entropy-code tables, generated from the format definition.

The QB3 per-value code is a three-range variable length code at a given
``rung`` r (the bit-rank of the largest magnitude in a group of 16):

  * short   : v <  2^(r-1)          -> r   bits:  v*2          (low bit 0)
  * nominal : 2^(r-1) <= v < 2^r    -> r+1 bits:  4*(v-2^(r-1)) + 0b01
  * long    : 2^r <= v < 2^(r+1)    -> r+2 bits:  4*(v-2^r)    + 0b11

(reference: attic/tables.py:37-45, QB3encode.h:132-141; bits are emitted LSB
first into a little-endian bitstream).

Two "middle swap" refinements shorten natural-image streams (QB3encode.h:30-33):

  * in the per-rung tables for rungs 3..7, the codes of values 2^r-1 and 2^r
    are exchanged;
  * in group context, rung 1 exchanges values 1 and 2 and rung 2 exchanges
    values 3 and 4 (QB3encode.h:183-197); single-value context (common-factor
    values, index-encoding unique values) uses the unswapped rung 1/2 code
    (QB3encode.h:26, qb3csztbl QB3encode.h:144-150).

For rungs >= 8 the code is computed directly from the formula above with no
swap (QB3encode.h:132-141, QB3decode.h:119-129).

The codeswitch code encodes the rung delta between consecutive groups of one
band on ``u = UBITS`` bits (3/4/5/6 for 8/16/32/64-bit types): delta 0 is a
single 0 bit; otherwise a 1 bit followed by the mag-sign of the biased delta
encoded at rung u-1 (attic/tables.py:115-133).  The "switch to the same rung"
long form is unused by normal groups and doubles as the SIGNAL prefix for the
common-factor and index group encodings (QB3encode.h:286).

Everything here is generated; nothing is copied from the reference arrays.
"""

from __future__ import annotations

import numpy as np

from .constants import B2


def vlc(v: int, rung: int) -> tuple[int, int]:
    """Base three-range VLC: value ``v`` at ``rung`` -> (nbits, code)."""
    if rung == 0:
        return 1, v & 1
    half = 1 << (rung - 1)
    if v < half:  # short
        return rung, v * 2
    if v < 2 * half:  # nominal
        return rung + 1, 4 * (v - half) + 0b01
    return rung + 2, 4 * (v - 2 * half) + 0b11  # long


def vlc_len(v: int, rung: int) -> int:
    return vlc(v, rung)[0]


def _swapped_pair(rung: int) -> tuple[int, int] | None:
    """The value pair exchanged in the per-rung tables (rungs 3..7)."""
    if 3 <= rung <= 7:
        return (1 << rung) - 1, 1 << rung
    return None


def _make_encode_table(rung: int, group: bool) -> np.ndarray:
    """(2^(rung+1), 2) array of (len, code) for one rung, optionally group ctx."""
    n = 1 << (rung + 1)
    out = np.zeros((n, 2), dtype=np.uint32)
    remap = {}
    pair = _swapped_pair(rung)
    if pair:
        remap = {pair[0]: pair[1], pair[1]: pair[0]}
    if group and rung == 1:
        remap = {1: 2, 2: 1}
    if group and rung == 2:
        remap = {3: 4, 4: 3}
    for v in range(n):
        ln, code = vlc(remap.get(v, v), rung)
        out[v] = (ln, code)
    return out


def _plain_encode_table(rung: int) -> np.ndarray:
    """Unswapped base VLC table (used by the codeswitch code)."""
    n = 1 << (rung + 1)
    out = np.zeros((n, 2), dtype=np.uint32)
    for v in range(n):
        out[v] = vlc(v, rung)
    return out


def _invert(enc: np.ndarray, rung: int) -> np.ndarray:
    nbits = rung + 2
    out = np.zeros((1 << nbits, 2), dtype=np.uint32)
    for v in range(enc.shape[0]):
        ln, code = int(enc[v, 0]), int(enc[v, 1])
        for hi in range(1 << (nbits - ln)):
            out[(hi << ln) | code] = (ln, v)
    return out


def _make_decode_table(rung: int, group: bool) -> np.ndarray:
    """(2^(rung+2), 2) array of (len, value): index = low rung+2 stream bits."""
    return _invert(_make_encode_table(rung, group), rung)


MAX_TBL_RUNG = 7  # tables cover rungs 0..7; higher rungs are computed


def _stack(tables: list[np.ndarray], width: int) -> np.ndarray:
    out = np.zeros((len(tables), width, 2), dtype=np.uint32)
    for r, t in enumerate(tables):
        out[r, : t.shape[0]] = t
    return out


# (8, 256, 2): [rung, value] -> (len, code); single-value context (qb3csztbl)
ENC_SINGLE = _stack([_make_encode_table(r, False) for r in range(8)], 256)
# (8, 256, 2): group context (groupencode) with rung 1/2 swaps
ENC_GROUP = _stack([_make_encode_table(r, True) for r in range(8)], 256)
# (8, 512, 2): [rung, low rung+2 bits] -> (len, value)
DEC_SINGLE = _stack([_make_decode_table(r, False) for r in range(8)], 512)
DEC_GROUP = _stack([_make_decode_table(r, True) for r in range(8)], 512)


def _mags8(v: int) -> int:
    v &= 0xFF
    return 0xFF & ((0xFF * (v >> 7)) ^ (v << 1))


def _smag8(v: int) -> int:
    return -((v >> 1) + 1) if (v & 1) else v >> 1


def _cs_magsign(delta: int, u: int) -> int:
    """Mag-sign symbol for a codeswitch delta on u bits (attic/tables.py:115-121).

    Negative deltas (sign bit set on u bits) map to mags(delta - 2^u); positive
    deltas are biased down by one so that delta==2^(u-1) (max "positive")
    wraps to the top, freeing the zero symbol for the SIGNAL long form.
    """
    sbit = 1 << (u - 1)
    if delta & sbit:
        return _mags8(delta - 2 * sbit)
    return _mags8((delta - 1) & (sbit - 1))


def _make_csw(u: int) -> np.ndarray:
    """(2^u, 2) of (len, code) for rung delta; code includes the change flag."""
    out = np.zeros((1 << u, 2), dtype=np.uint32)
    out[0] = (1, 0)  # no change: single 0 bit
    for d in range(1, 1 << u):
        ln, code = vlc(_cs_magsign(d, u), u - 1)
        out[d] = (ln + 1, (code << 1) | 1)
    return out


def _make_signal(u: int) -> tuple[int, int]:
    """The 'switch to same rung' long form used as CF/index SIGNAL."""
    ln, code = vlc(_cs_magsign(0, u), u - 1)
    return ln + 1, (code << 1) | 1


def _make_dsw(u: int) -> np.ndarray:
    """(2^(u+1), 2) of (len incl flag, delta): index = u+1 bits after the flag.

    The SIGNAL long form decodes to delta 0 (attic/tables.py:137-151).
    """
    out = np.zeros((1 << (u + 1), 2), dtype=np.uint32)
    # the codeswitch uses the plain VLC (no middle swap) at rung u-1
    dec = _invert(_plain_encode_table(u - 1), u - 1)
    for bits in range(1 << (u + 1)):
        ln, v = int(dec[bits, 0]), int(dec[bits, 1])
        sv = _smag8(v)
        if sv >= 0:
            delta = (sv + 1) & ((1 << (u - 1)) - 1)
        else:
            delta = sv & ((1 << u) - 1)
        out[bits] = (ln + 1, delta)
    return out


# Codeswitch tables indexed by UBITS (3..6); padded stack at [u]
CSW = np.zeros((7, 64, 2), dtype=np.uint32)
DSW = np.zeros((7, 128, 2), dtype=np.uint32)
SIGNAL = np.zeros((7, 2), dtype=np.uint32)
for _u in (3, 4, 5, 6):
    CSW[_u, : 1 << _u] = _make_csw(_u)
    DSW[_u, : 1 << (_u + 1)] = _make_dsw(_u)
    SIGNAL[_u] = _make_signal(_u)
del _u

# Index-encoding index codes: plain (unswapped) rung-2 code (QB3encode.h:598-601)
IDX_ENC = ENC_SINGLE[2]
IDX_DEC = DEC_SINGLE[2]


def computed_code(v: int, rung: int) -> tuple[int, int]:
    """qb3csz for rung >= 2 on arbitrary-width ints (QB3encode.h:132-141).

    Returns (nbits, code) where code may be up to 65 bits for rung 63 (the
    reference emits the low 64 bits then bit 62 of the value separately,
    QB3encode.h:267-274; the resulting bit pattern equals this full code).
    """
    assert rung > 1
    nxt = (v >> (rung - 1)) & 1
    top = v >> rung
    tb = 1 << rung
    nbits = rung + top + (top | nxt)
    if top:
        code = ((v ^ tb) << 2) | 0b11
    elif nxt:
        code = (((v << 1) ^ tb) << 1) | 0b01
    else:
        code = v << 1
    return nbits, code
