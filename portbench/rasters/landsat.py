"""The configuration landsat8-u16x8-cfh's rasters: the repository's real
Landsat tile (web/sample_landsat8.qb3) and variants of it, a stand-in for
a scene's many tiles.

make(conf, n, rng) -> (n, H, W, C) tiles: the sample's raster first.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np

from ..reference import pins, qb3ref

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(HERE, "cache")  # git-ignored; made by the first run of a checkout


def raster(root: str = ".") -> np.ndarray:
    """The Landsat sample's raster, decoded by the reference decoder and
    checked against its pin; cached in portbench/cache/ after the first
    run of a checkout."""
    path = os.path.join(CACHE, "landsat8.npy")
    if os.path.exists(path):
        img = np.load(path)
    else:
        with open(os.path.join(root, pins.LANDSAT_SAMPLE), "rb") as f:
            img = qb3ref.decode(f.read())
    if hashlib.sha256(img.tobytes()).hexdigest() != pins.LANDSAT_SHA256:
        raise RuntimeError("the Landsat raster does not match its pin")
    if not os.path.exists(path):
        os.makedirs(CACHE, exist_ok=True)
        tmp = path + ".part.npy"
        np.save(tmp, img)
        os.replace(tmp, path)
    return img


def make(conf: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """The sample's raster, then n - 1 variants of it: each one of the 8
    flips and quarter turns, shifted cyclically by a multiple of 4 rows
    and of 4 columns (so its 4x4 blocks are the sample's, moved)."""
    img = raster()
    h, w = img.shape[:2]
    crop = conf.get("crop")
    if crop:  # the tests' small size
        img = np.ascontiguousarray(img[:crop, :crop])
        h = w = crop
    out = [img]
    for _ in range(n - 1):
        k = int(rng.integers(0, 8))
        x = np.rot90(img, k % 4, (0, 1))
        if k >= 4:
            x = x[::-1]
        dy, dx = (4 * int(v) for v in rng.integers(0, [h // 4, w // 4]))
        out.append(np.roll(x, (dy, dx), (0, 1)))
    return np.ascontiguousarray(np.stack(out))
