"""The configuration srtm90-i16-cfrle-q4's scenes: seeded int16 terrain in
the form of a CGIAR-CSI SRTM 90 m v4.1 tile, a stand-in for the archive's
tiles, none of which is in the repository.

make(conf, n, rng) -> (n, H, W, 1) int16 scenes at the configuration's
height and width.  Each scene is land from 0 to about TOP_M metres, made of
octaves of smoothed noise on a grid of GRID pixels with a pixel-scale
roughness that grows with height (a few metres in the plains, ~15 m on
the peaks), and a sea at SEA (the tiles' void and
sea value) behind a seeded coastline over about a quarter of the scene.
Everything is whole-array NumPy (float32 on the grid, int16 at full
size): a 6000 x 6000 scene is a handful of passes over its 36 million
values.
"""

from __future__ import annotations

import numpy as np

SEA = -32768
TOP_M = 4500.0
SEA_SHARE = 0.25
GRID = 8  # pixels between the terrain's grid points; finer relief is the roughness
RAMP = 0.15  # the coastal plain: the share of the coast field's range over which land rises


def _resize(a: np.ndarray, h: int, w: int) -> np.ndarray:
    """a bilinearly resampled to (h, w), corners on corners."""
    def axis(a, n, ax):
        pos = np.linspace(0, a.shape[ax] - 1, n, dtype=np.float32)
        i0 = np.minimum(pos.astype(np.int64), a.shape[ax] - 2) if a.shape[ax] > 1 else \
            np.zeros(n, np.int64)
        f = (pos - i0).astype(np.float32)
        lo = np.take(a, i0, ax)
        hi = np.take(a, np.minimum(i0 + 1, a.shape[ax] - 1), ax)
        f = f[:, None] if ax == 0 else f[None, :]
        return lo + (hi - lo) * f

    return axis(axis(a, h, 0), w, 1)


def _upsample(a: np.ndarray, f: int) -> np.ndarray:
    """a (h, w) bilinearly upsampled by the whole factor f to
    ((h - 1) f, (w - 1) f): each grid cell filled by broadcasting, in
    place."""
    t = np.arange(f, dtype=np.float32) / f
    rows = np.empty((a.shape[0] - 1, f, a.shape[1]), np.float32)
    np.multiply((a[1:] - a[:-1])[:, None, :], t[None, :, None], out=rows)
    rows += a[:-1, None, :]
    rows = rows.reshape(-1, a.shape[1])
    out = np.empty((rows.shape[0], a.shape[1] - 1, f), np.float32)
    np.multiply((rows[:, 1:] - rows[:, :-1])[:, :, None], t[None, None, :], out=out)
    out += rows[:, :-1, None]
    return out.reshape(rows.shape[0], -1)


def _octaves(rng: np.random.Generator, h: int, w: int, first: int, last: int) -> np.ndarray:
    """Sum of noise octaves on an (h, w) grid: octave k is uniform noise on a
    (2^k + 1)-point grid, resampled, at amplitude 2^-k (a rough, fractal
    relief); k from first to last, no finer than the grid itself."""
    out = np.zeros((h, w), np.float32)
    for k in range(first, last + 1):
        n = (1 << k) + 1
        if n > max(h, w):
            break
        out += _resize(rng.random((n, n), dtype=np.float32), h, w) * np.float32(0.5 ** k)
    return out


def scene(h: int, w: int, rng: np.random.Generator) -> np.ndarray:
    """One (h, w, 1) int16 scene (see the module docstring)."""
    gh, gw = -(-h // GRID) + 1, -(-w // GRID) + 1
    relief = _octaves(rng, gh, gw, 1, 10)
    relief = (relief - relief.min()) / max(float(np.ptp(relief)), 1e-6)
    coast = _octaves(rng, gh, gw, 1, 4)
    level = np.quantile(coast, SEA_SHARE)
    rise = np.clip((coast - level) / (RAMP * max(float(np.ptp(coast)), 1e-6)), 0, 1)
    # metres on the grid; the sea far below 0, so that the coast's grid cells
    # interpolate below 0 and join the sea
    grid = np.where(coast < level, np.float32(-1000),
                    np.float32(TOP_M) * relief * relief * rise).astype(np.float32)
    elev = _upsample(grid, GRID)[:h, :w].astype(np.int16)
    # the roughness: a triangular law on -7..7 m from one random byte a
    # pixel, wider by a step a kilometre of height
    b = np.frombuffer(rng.bytes(h * w), np.uint8).reshape(h, w)
    rough = (b & 7).astype(np.int16)
    rough -= b >> 5
    rough *= 1 + (elev >> 10)
    rough += elev
    np.maximum(rough, 0, out=rough)
    rough[elev < 0] = SEA
    return rough[..., None]


def make(conf: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """n scenes of the configuration's height and width, each drawn in turn
    from rng."""
    out = np.empty((n, conf["height"], conf["width"], 1), np.int16)
    for i in range(n):
        out[i] = scene(conf["height"], conf["width"], rng)
    return out
