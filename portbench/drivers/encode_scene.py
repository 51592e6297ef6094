"""Driver: qb3_tpu_torch.strip.StripEncoder, a closed loop of whole scenes
(the ingest of an elevation archive, which turns each source tile into one
stream without holding it whole).

A unit of work is one scene: a StripEncoder built at the configuration's
size, type, mode, step and strip_rows, fed the scene's rows in pieces of
the mix's push_rows (6000 rows: 11 pieces of 512 and one of 368), then
finish().  A scene counts when finish() returns its stream.  One stream of
the window, at a seeded position (each completed scene replaces the kept
one with chance 1/k, k its rank), is kept for the check, which compares
check_streams of the kept ones with the plain reference's stream.  The
warm-up of warmup_scenes scenes meets both strip shapes.
"""

from __future__ import annotations

import numpy as np

from portbench import loops, registry
from portbench.traffic import Traffic

# the entry the window drives, and what goes in and out of it (faults.py)
ENTRY = "qb3_tpu_torch.strip:StripEncoder"
SHAPE = "stream_scene"


def setup(cell: dict, run) -> dict:
    from qb3_tpu_torch.api import DT_FROM_NP

    conf, tr = cell["config"], cell["traffic"]
    traffic = Traffic(tr, run.rng(2))
    pool = registry.rasters(conf, traffic.pool, run.rng(1))
    st = dict(pool=pool, conf=conf, cell=cell, draws=traffic.batches(),
              push=int(tr["push_rows"]), dtype=DT_FROM_NP[pool.dtype], kept=[], seen=0,
              pos=run.rng(4))
    for _ in range(cell["warmup_scenes"]):
        step(st, run)
    return st


def encode(st: dict, scene: np.ndarray, device: str) -> bytes:
    """One scene through the strip encoder, looked up in its module at each
    build (faults.py replaces it there)."""
    from qb3_tpu_torch import strip

    conf = st["conf"]
    h, w, c = scene.shape
    enc = strip.StripEncoder(w, h, c, st["dtype"], mode=loops.MODES[conf["mode"]],
                             quanta=conf.get("quanta", 1), away=conf.get("away", False),
                             coreband=conf.get("coreband"), strip_rows=conf["strip_rows"],
                             device=device)
    for y in range(0, h, st["push"]):
        enc.push(scene[y: y + st["push"]])
    return enc.finish()


def step(st: dict, run) -> None:
    _, idx = next(st["draws"])
    i = int(idx[0])
    scene = st["pool"][i]
    stream = encode(st, scene, run.device)
    run.done(1, scene.nbytes, len(stream))
    if run.phase == "window":
        st["seen"] += 1
        if int(st["pos"].integers(0, st["seen"])) == 0:
            st["kept"] = [(i, stream)]


def window(st: dict, seconds: float, run, phase: str) -> dict:
    s = loops.closed_window(lambda: step(st, run), seconds, run, phase)
    return {"encode_MBps": run.totals(phase)[1] / 1e6 / s}


def verify(st: dict, run):
    wrong = loops.streams_differ(st["kept"], st["pool"], st["conf"],
                                 st["cell"]["check_streams"], run.rng(3))
    return {"streams_differ": (wrong, 0)}, st["seen"], 0
