"""The configuration cid22-rgb8-ftl's rasters: seeded stand-ins for CID22's
512x512 RGB8 images (the CID22 set itself is not in the repository).

make(conf, n, rng) -> (n, H, W, C) tiles, each a headline raster from a
seed of its own drawn from rng, made on 8 threads.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

def headline_image(h: int = 512, w: int = 512, bands: int = 3, seed: int = 42,
                   dtype=np.uint8) -> np.ndarray:
    """A smooth (H, W, C) raster with grain and hard edges, made with
    integer numpy only, so every machine makes the same bytes: a frozen copy
    of qb3_tpu_torch/benchutil.py's headline_image (the main path's input,
    whose FTL "ic" stream is pinned by pins.HEADLINE_SHA256)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.int64)
    out = np.empty((h, w, bands), np.int64)
    for c in range(bands):
        f = rng.integers(0, 32, size=(h, w), dtype=np.int64)
        for _ in range(2):  # box smoothing: neighbours average in integers
            f = (f + np.roll(f, 1, 0) + np.roll(f, 1, 1) + np.roll(f, (1, 1), (0, 1))) // 4
        f = f + (x * (96 + 16 * c)) // w + (y * 64) // h + 40
        f[(x + 2 * y) % 61 < 2] += 60  # edges: rung jumps
        out[:, :, c] = np.clip(f, 0, 255)
    if np.dtype(dtype).itemsize == 1:
        return out.astype(dtype)
    k = 4 * np.dtype(dtype).itemsize - 4
    grain = rng.integers(0, 1 << k, size=out.shape, dtype=np.int64)
    return ((out.astype(np.uint64) << np.uint64(k))
            | grain.astype(np.uint64)).astype(dtype)


def make(conf: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """n headline rasters of the configuration's size, each from a seed of
    its own drawn from rng; made on 8 threads."""
    seeds = [int(s) for s in rng.integers(0, 1 << 62, n)]
    dt = np.dtype(conf["dtype"])

    def one(s):
        return headline_image(conf["height"], conf["width"], conf["bands"], s, dt)

    with ThreadPoolExecutor(8) as ex:
        return np.stack(list(ex.map(one, seeds)))
