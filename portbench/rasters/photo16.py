"""The configuration rgb16-photo-ftl's images: seeded 16-bit RGB photographs
in the form of the imagecompression.info 16-bit RGB set's linear images, a
stand-in for the set's masters, none of which is in the repository.

make(conf, n, rng) -> (n, H, W, 3) uint16 images at the configuration's
height and width.  Each image is a linear sensor's reading of a smooth
scene: a luminance made of noise octaves whose wavelengths are fixed in
pixels (GRID pixels to GRID * 2^(OCTAVES-1)), so that a cut of an image
has the statistics of the whole, exposed so that its EXPOSE percentiles
fall on BLACK and WHITE and raised to GAMMA, times a slowly varying colour
gain a channel (the green channel's 1, red's and blue's below it), so that
the three channels move together.  Over it lies the sensor's noise: a shot
noise whose variance is GAIN times the green signal, with the read noise
READ under it, shared by the three channels (as a demosaic shares it), and
a weaker part, CHROMA of it, drawn for each channel alone.  The core band
(R-G, G, B-G) takes the shared part out of the red and the blue.  At these
constants the values span ~500 to ~63700 and the FTL stream of an image
is ~0.66-0.72 of its raw bytes (0.69-0.71 at 256 x 384), near the set's
published FTL reduction of about 30%.

Everything is whole-array NumPy in bands of BAND rows (float32; the noise
from random bytes as the difference of two nibbles), ~8-11 ns a value.
"""

from __future__ import annotations

import numpy as np

GRID = 8  # pixels between the scene's grid points
OCTAVES = 10  # the scene's noise octaves: wavelengths GRID * 2^j pixels
BLACK, WHITE = 1024.0, 60000.0  # the sensor's black level and the scene's white
GAMMA = 2.2  # the scene's luminance to the linear signal
EXPOSE = (1.0, 99.0)  # the luminance's percentiles set at BLACK and WHITE
GAIN = 24.0  # the shot noise's variance over the signal, in DN
READ = 40.0  # the read noise's deviation, in DN
CHROMA = 0.35  # each channel's own noise, as a share of the shared noise
BAND = 16  # rows made at once (a multiple of GRID)
_TRI = np.sqrt(2 * (16 ** 2 - 1) / 12)  # deviation of a nibble difference


def _lerp(a: np.ndarray, n: int, f: int, axis: int) -> np.ndarray:
    """a linearly resampled along axis at n points f times as dense, grid
    point k of a at point k f: the first n points of its upsampling by f."""
    pos = np.arange(n)
    i0 = pos // f
    t = ((pos % f) / np.float32(f)).astype(np.float32)
    lo, hi = np.take(a, i0, axis), np.take(a, i0 + 1, axis)
    t = t.reshape((-1,) + (1,) * (a.ndim - 1 - axis))
    return lo + (hi - lo) * t


def _octaves(rng: np.random.Generator, gh: int, gw: int, first: int) -> np.ndarray:
    """Noise octaves on a (gh, gw) grid, each at its own spacing of 2^j grid
    points and an amplitude in proportion to it (j from first to
    OCTAVES - 1), cut to the grid: an octave longer than the image shows
    only its part of a wave.  Scaled so that the sum's deviation is ~1/4."""
    out = np.zeros((gh, gw), np.float32)
    norm = 0.0
    for j in range(first, OCTAVES):
        s = 1 << j
        coarse = rng.random((-(-gh // s) + 1, -(-gw // s) + 1), dtype=np.float32)
        out += _lerp(_lerp(coarse - np.float32(0.5), gh, s, 0), gw, s, 1) * np.float32(s)
        norm += s * s
    return out * np.float32(0.25 / np.sqrt(norm / 12.0))


def _grid(rng: np.random.Generator, gh: int, gw: int) -> np.ndarray:
    """The scene's signal on the grid, (3, gh, gw) float32 DN: R, G, B."""
    lum = _octaves(rng, gh, gw, 0)
    lo, hi = np.percentile(lum, EXPOSE)  # the exposure: the scene spread over the range
    lum = np.clip((lum - np.float32(lo)) / np.float32(max(hi - lo, 1e-6)), 0, 1)
    lum **= np.float32(GAMMA)
    red = np.clip(np.float32(0.75) + np.float32(0.8) * _octaves(rng, gh, gw, 4), 0.4, 1)
    blue = np.clip(np.float32(0.65) + np.float32(0.8) * _octaves(rng, gh, gw, 4), 0.3, 1)
    return np.float32(BLACK) + np.float32(WHITE - BLACK) * np.stack([lum * red, lum, lum * blue])


def _nibbles(raw: np.ndarray) -> np.ndarray:
    """Random bytes -> int8 noise of deviation _TRI, from -15 to 15: each
    byte's low nibble less its high one."""
    return (raw & 15).view(np.int8) - (raw >> 4).view(np.int8)


def image(h: int, w: int, rng: np.random.Generator, out: np.ndarray | None = None) -> np.ndarray:
    """One (h, w, 3) uint16 image (see the module docstring), into out where
    given.  No value leaves the type: the noise is at most 15 (1 + CHROMA)
    / _TRI ~ 3.1 deviations, ~380 DN at BLACK and ~2750 at WHITE."""
    out = np.empty((h, w, 3), np.uint16) if out is None else out
    grid = _grid(rng, -(-h // GRID) + 1, -(-w // GRID) + 1)
    t = (np.arange(GRID) / np.float32(GRID)).astype(np.float32)[:, None]
    for y in range(0, h, BAND):
        rows = min(BAND, h - y)
        g0, g1 = y // GRID, -(-(y + rows) // GRID)
        # the smooth signal, (3, rows, w): along the grid's rows first, then down
        cols = _lerp(grid[:, g0: g1 + 1], w, GRID, 2)
        sm = (cols[:, 1:] - cols[:, :-1])[:, :, None] * t
        sm += cols[:, :-1, None]
        sm = sm.reshape(3, -1, w)[:, :rows]
        # the shared noise's deviation, from the green signal, over _TRI
        s = np.sqrt(sm[1] * np.float32(GAIN) + np.float32(READ * READ)) / np.float32(_TRI)
        raw = rng.bit_generator.random_raw(-(-4 * rows * w // 8)).view(np.uint8)
        noise = _nibbles(raw[: 3 * rows * w]).astype(np.float32).reshape(3, rows, w)
        noise *= np.float32(CHROMA)
        noise += _nibbles(raw[3 * rows * w: 4 * rows * w]).reshape(rows, w)
        noise *= s
        noise += sm
        out[y: y + rows] = noise.astype(np.uint16).transpose(1, 2, 0)
    return out


def make(conf: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """n images of the configuration's height and width, each drawn in turn
    from rng."""
    out = np.empty((n, conf["height"], conf["width"], 3), np.uint16)
    for i in range(n):
        image(conf["height"], conf["width"], rng, out[i])
    return out
