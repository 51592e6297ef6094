"""Driver: qb3_tpu_torch.foreign.decode_streams_pipelined, a closed loop of
batches of sidecar-free streams (the bulk decode of tiles another encoder
wrote).

The pool's first stream is the configuration's sample file, byte for
byte; the others are its variants encoded once at set-up with the
program's batch encode in the configuration's mode.  A batch counts when
its arrays reach the host.  One tile of each batch, at a seeded position,
is copied for the check.
"""

from __future__ import annotations

import collections

import numpy as np

from portbench import loops, registry
from portbench.traffic import Traffic


# the entry the window drives, and what goes in and out of it (faults.py)
ENTRY = "qb3_tpu_torch.foreign:decode_streams_pipelined"
SHAPE = "array_batches"


def setup(cell: dict, run) -> dict:
    from qb3_tpu_torch import batch, foreign

    conf, tr = cell["config"], cell["traffic"]
    traffic = Traffic(tr, run.rng(2))
    pool = registry.rasters(conf, traffic.pool, run.rng(1))
    with open(conf["sample"], "rb") as f:
        streams = [f.read()] if not conf.get("crop") else []
    rest = pool[len(streams):]
    for i in range(0, len(rest), traffic.batch):
        streams += batch.encode_tiles(rest[i: i + traffic.batch],
                                      mode=loops.MODES[conf["mode"]],
                                      coreband=conf.get("coreband"), device=run.device)
    sent = collections.deque()

    def feed():
        for _, idx in traffic.batches():
            sent.append(idx)
            yield [streams[j] for j in idx]

    st = dict(pool=pool, conf=conf, sizes=[len(s) for s in streams], sent=sent, kept=[], missing=0,
              attempted=0, pos=run.rng(4),
              gen=foreign.decode_streams_pipelined(feed(), device=run.device))
    for _ in range(cell["warmup_batches"]):
        step(st, run)
    return st


def step(st: dict, run) -> None:
    tiles = next(st["gen"])
    idx = st["sent"].popleft()
    n = min(len(tiles), len(idx))
    run.done(n, int(tiles[:n].nbytes), sum(st["sizes"][int(j)] for j in idx[:n]))
    if run.phase == "window":
        st["attempted"] += len(idx)
        st["missing"] += len(idx) - n
        j = int(st["pos"].integers(0, len(idx)))
        if j < n:
            st["kept"].append((int(idx[j]), np.array(tiles[j])))


def window(st: dict, seconds: float, run, phase: str) -> dict:
    s = loops.closed_window(lambda: step(st, run), seconds, run, phase)
    return {"decode_MBps": run.totals(phase)[1] / 1e6 / s}


def verify(st: dict, run):
    st.pop("gen").close()
    wrong = loops.arrays_differ(st["kept"], st["pool"], st["conf"])
    return ({"tiles_differ": (wrong, 0), "tiles_missing": (st["missing"], 0)},
            st["attempted"], st["missing"])
