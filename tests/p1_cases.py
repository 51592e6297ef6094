"""Inputs of P1 (the dim-0 contraction aᵀ·b, ops/probe_cuda.dim0_dot)
beyond the probe's own shape, shared by the CPU test against
jax.lax.dot_general (test_torch_probes.py) and the card test against the
twin (test_torch_cuda.py).  Imports neither jax nor torch."""

import numpy as np

# (K, M, N): single elements, ragged tiles (M or N not a multiple of 8:
# rows the threads read), several CTAs along M and N, the probe's shape,
# and a long contraction (192 K slices)
SHAPES = [(1, 1, 1), (33, 5, 9), (40, 70, 24), (256, 64, 128), (300, 130, 200),
          (1024, 256, 512), (12288, 64, 128)]
CPU_SHAPES = SHAPES[:5]  # the twin and dot_general at CPU sizes


def inputs(shape, integer: bool):
    """a (K, M) and b (K, N) float32 arrays whose values are bf16 exactly,
    from a seed of the shape.  integer: values in -8 .. 8, so every partial
    sum of up to 2^18 products is an integer below 2^24 and any summation
    order gives the exact result; else standard normal values rounded to
    bf16 (round to nearest even on the top 16 bits)."""
    k, m, n = shape
    rng = np.random.default_rng(k * 1_000_003 + m * 1009 + n)
    out = []
    for cols in (m, n):
        if integer:
            x = rng.integers(-8, 9, (k, cols)).astype(np.float32)
        else:
            bits = rng.standard_normal((k, cols)).astype(np.float32).view(np.uint32)
            bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
            x = bits.view(np.float32)
        out.append(x)
    return tuple(out)


def tolerance(a, b) -> np.ndarray:
    """The bound on |kernel - exact| for random inputs: 2^-16 of the sum of
    |a_km b_kn| over k, in float64.  float32 sums in any order stay well
    inside it; a wrong row or column is off by O(1)."""
    return 2.0 ** -16 * (np.abs(a).astype(np.float64).T @ np.abs(b).astype(np.float64))
