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

import torch

from ..constants import B2

M32 = 0xFFFFFFFF


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
    """Absolute value of a mag-sign value (QB3encode.h:92)."""
    return srl(v, 1) + (v & 1)


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
