"""Small vectorized bit-manipulation primitives shared by encode/decode.

PyTorch counterpart of qb3_tpu/ops/bitutils.py.  PyTorch has no arithmetic,
shift or compare on uint16/32/64 tensors, so every value is carried in an
int64 tensor holding the unsigned bit pattern:

  * values of a t-bit type (t < 64) are non-negative and masked to t bits
    (:func:`wrap`) after every operation that can leave that range;
  * 64-bit values are the raw two's complement pattern: int64 add, subtract,
    multiply and left shift wrap exactly like uint64;
  * ``>>`` on int64 is arithmetic, so every right shift of a value that may
    have bit 63 set goes through :func:`srl` (a shift followed by ``& 1``
    needs no mask: it extracts one bit either way).
"""

from __future__ import annotations

import functools

import torch

from ..constants import B2

M32 = 0xFFFFFFFF
_MIN64 = -(1 << 63)  # 2^63 as an int64 bit pattern


@functools.cache
def table(values: tuple, device) -> torch.Tensor:
    """A small constant int64 table (a curve's lane order, core bands) on
    `device`, uploaded once a process.  A copy from pageable host memory to
    a CUDA device synchronizes the current stream, so the paths that run
    behind other streams (pipeline.py) take their index tables from here
    rather than upload them at each call."""
    return torch.tensor(values, dtype=torch.int64, device=device)


def wrap(v, tbits: int):
    """Reduce an int64 carrier to the t-bit unsigned range (identity at 64)."""
    return v if tbits == 64 else v & ((1 << tbits) - 1)


def srl(v, s):
    """Logical right shift of int64 bit patterns by s in [0, 63] (an int or
    a tensor broadcastable against v)."""
    if isinstance(s, int):
        return v if s == 0 else (v >> s) & ((1 << (64 - s)) - 1)
    keep = (1 << (64 - s.clamp(min=1))) - 1
    return torch.where(s == 0, v, (v >> s) & keep)


def topbit(v):
    """floor(log2(v)) of non-zero int64 bit patterns (callers pass v|1),
    by a six-step binary search (QB3common.h:44-60)."""
    r = torch.zeros_like(v)
    for s in (32, 16, 8, 4, 2, 1):
        hi = srl(v, s)
        up = hi != 0
        r = r + torch.where(up, s, 0)
        v = torch.where(up, hi, v)
    return r


def mags(v, tbits: int):
    """Two's complement -> mag-sign with sign in bit 0 (QB3common.h:127-130)."""
    sign = (v >> (tbits - 1)) & 1
    return wrap((v << 1) ^ -sign, tbits)


def smag(v, tbits: int):
    """Mag-sign -> two's complement (QB3common.h:132-136)."""
    return wrap(srl(v, 1) ^ -(v & 1), tbits)


def magsabs(v):
    """Absolute value of a mag-sign value (QB3encode.h:92).  Of a 64-bit
    value it lies in [0, 2^63], and 2^63 (of 2^64 - 1) is negative as int64."""
    return srl(v, 1) + (v & 1)


def ult(a, b):
    """Unsigned a < b of int64 bit patterns: the signed compare of both
    biased by 2^63."""
    return (a ^ _MIN64) < (b ^ _MIN64)


def udiv(a, d):
    """Unsigned floor division of int64 bit patterns, d != 0: halve a so the
    signed division is exact, then correct the quotient by one (Hacker's
    Delight 9-3); a divisor of 2^63 or more gives 0 or 1."""
    q = (srl(a, 1) // d) << 1
    q = q + (~ult(a - q * d, d)).to(torch.int64)
    return torch.where(d < 0, (~ult(a, d)).to(torch.int64), q)


def magsdiv(v, cf, tbits: int):
    """Divide a mag-sign value by a factor cf >= 2 (QB3encode.h:95); of
    64-bit values the division is unsigned."""
    a = magsabs(v)
    q = udiv(a, cf) if tbits == 64 else a // cf
    return wrap((q << 1) - (v & 1), tbits)


def magsmul(v, m, tbits: int):
    """Multiply a mag-sign value by a positive factor (QB3decode.h:575),
    wrapping at the type's width."""
    return wrap(magsabs(v) * (m << 1) - (v & 1), tbits)


def step_flip_index(m, rung):
    """Vectorized step detector (QB3common.h:141-166).

    ``m`` is (..., B2) mag-sign values, ``rung`` is (...,) integer.  Returns
    (match, ones): ``match`` is True when the per-value rung bits in scan
    order form the pattern 1*0*, ``ones`` counts the set rung bits.
    """
    rungbits = (m >> rung[..., None]) & 1
    weights = 1 << torch.arange(B2, dtype=torch.int64, device=m.device)
    acc = (rungbits * weights).sum(-1)
    match = (acc & (acc + 1)) == 0  # low-ones pattern (incl. all-zero)
    ones = torch.where(acc == 0, 0, topbit(acc | 1) + 1)
    # encoder flips index ones-1 when match & ones>0 (QB3encode.h:169-176);
    # decoder flips index ones when match (QB3decode.h:285-289)
    return match, ones


def words_u32(words):
    """Flat int64 view of the payload as little-endian u32 words.

    Accepts int32 tensors holding u32 patterns (what the decoders ship) or
    int64 tensors holding u64 words (split low word first)."""
    if words.dtype == torch.int32:
        return words.reshape(-1).to(torch.int64) & M32
    w = words.reshape(-1, 1)
    return torch.cat([w & M32, srl(w, 32)], dim=1).reshape(-1)


def words_u64(words):
    """Flat int64 view of the payload as little-endian u64 words; converse
    of :func:`words_u32` (int32 u32 pairs are joined low word first)."""
    if words.dtype == torch.int64:
        return words.reshape(-1)
    w = words.reshape(-1, 2).to(torch.int64) & M32
    return w[:, 0] | (w[:, 1] << 32)


def peek64(words64, bitpos):
    """64 stream bits at any-shape int64 bit offsets (iBits::peek,
    bitstream.h:39-50), with JAX's gather rules: a negative word index
    counts from the end, then indices clamp into the stream."""
    n = words64.shape[0]

    def word(i):
        return words64[torch.where(i < 0, i + n, i).clamp(0, n - 1)]

    widx = bitpos >> 6
    sh = bitpos & 63
    hi = torch.where(sh == 0, 0, word(widx + 1) << ((64 - sh) & 63))
    return srl(word(widx), sh) | hi
