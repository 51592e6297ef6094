"""The grid that holds K11 (qb3_tpu_torch/ops/quantize_cuda.py, on the card)
and its twin (on the CPU) to api.quantize: every integer type, the steps 2,
3, 4, 5, 7, 255 and the type's largest where the type holds them, ties
toward zero and away, on edge values and seeded random bit patterns.
Shared by tests/test_torch_quantize.py and tests/test_torch_cuda.py.
"""

import numpy as np

TYPES = (np.uint8, np.int8, np.uint16, np.int16, np.uint32, np.int32, np.uint64, np.int64)


def steps(dtype) -> list[int]:
    top = int(np.iinfo(dtype).max)
    return sorted({q for q in (2, 3, 4, 5, 7, 255, top) if q <= top})


# name -> (dtype, step, away)
CASES = {f"{np.dtype(t).name}-q{q}-{'away' if away else 'zero'}": (t, q, away)
         for t in TYPES for q in steps(t) for away in (False, True)}


def values(dtype, q: int, n_random: int = 4096, seed: int = 0) -> np.ndarray:
    """The type's min and max, 0, -32768, 2^63 - 1, 2^63 and 2^63 + 1, k*q
    + e for k in -6..6 and at both ends of the range, e in -2..2 and +-q/2
    and +-(q+1)/2 (ties and their neighbours), each wrapped into the type
    (u64 values above 2^63 among them); then n_random seeded bit patterns."""
    info = np.iinfo(dtype)
    lo, hi = int(info.min), int(info.max)
    vals = [lo, hi, 0, -32768, 2**63 - 1, 2**63, 2**63 + 1]
    for k in [*range(-6, 7), hi // q, -(hi // q), lo // q, 2**63 // q]:
        vals += [k * q + e for e in (-2, -1, 0, 1, 2, q // 2, -(q // 2), (q + 1) // 2,
                                     -((q + 1) // 2))]
    udt = np.dtype(f"u{info.bits // 8}")
    mod = 1 << info.bits
    edge = np.array([v % mod for v in vals], dtype=np.uint64).astype(udt)
    rng = np.random.default_rng(seed)
    rnd = rng.integers(0, 1 << 64, n_random, dtype=np.uint64, endpoint=False).astype(udt)
    return np.concatenate([edge, rnd]).view(dtype)


def signed_view(arr: np.ndarray) -> np.ndarray:
    """The values as the encoders upload them: u8 and i8 as uint8, wider
    types as their signed view (api.to_carrier's), in the tensor type
    ops/quantize_cuda.SOURCE names."""
    size = arr.dtype.itemsize
    return arr.view(np.dtype(f"i{size}") if size > 1 else np.uint8)


def k11_model(arr: np.ndarray, q: int, away: bool) -> np.ndarray:
    """K11's arithmetic (csrc/quantize.cu) on Python integers: the quotient
    truncated toward zero, plus one where the remainder reaches lim, minus
    one where it reaches -lim (lim = q // 2 + 1, or q - q // 2 away), as the
    type's unsigned twin."""
    lim = q - q // 2 if away else q // 2 + 1
    bits = np.iinfo(arr.dtype).bits
    out = []
    for v in arr.tolist():
        quo = abs(v) // q * (1 if v >= 0 else -1)
        rem = v - quo * q
        out.append((quo + (rem >= lim) - (rem <= -lim)) % (1 << bits))
    return np.array(out, dtype=np.uint64).astype(np.dtype(f"u{bits // 8}"))
