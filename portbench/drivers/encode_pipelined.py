"""Driver: qb3_tpu_torch.pipeline.encode_tiles_pipelined, a closed loop of
same-shape tile batches (the ingest of an archive).

The program's generator is made once at set-up and fed one batch after
another; the window continues it where the warm-up left it, so its
upload, compute and fetch streams stay full.  A batch counts when its
streams reach the host.  One stream of each batch, at a seeded position,
is kept for the check.
"""

from __future__ import annotations

import collections

from portbench import loops, registry
from portbench.traffic import Traffic


# the entry the window drives, and what goes in and out of it (faults.py)
ENTRY = "qb3_tpu_torch.pipeline:encode_tiles_pipelined"
SHAPE = "stream_batches"


def setup(cell: dict, run) -> dict:
    from qb3_tpu_torch import pipeline

    conf, tr = cell["config"], cell["traffic"]
    traffic = Traffic(tr, run.rng(2))
    pool = registry.rasters(conf, traffic.pool, run.rng(1))
    laid = pool[traffic.arrangement]  # each batch a contiguous slice
    sent = collections.deque()

    def feed():
        for off, idx in traffic.batches():
            sent.append(idx)
            yield laid[off: off + traffic.batch]

    st = dict(pool=pool, conf=conf, cell=cell, sent=sent, kept=[], missing=0, attempted=0,
              pos=run.rng(4), tile_bytes=pool[0].nbytes,
              gen=pipeline.encode_tiles_pipelined(
                  feed(), mode=loops.MODES[conf["mode"]], coreband=conf.get("coreband"),
                  index=conf.get("index") or False, device=run.device))
    for _ in range(cell["warmup_batches"]):
        step(st, run)
    return st


def step(st: dict, run) -> None:
    streams = next(st["gen"])
    idx = st["sent"].popleft()
    n = min(len(streams), len(idx))
    run.done(n, n * st["tile_bytes"], sum(len(s) for s in streams[:n]))
    if run.phase == "window":
        st["attempted"] += len(idx)
        st["missing"] += len(idx) - n
        j = int(st["pos"].integers(0, len(idx)))
        if j < n:
            st["kept"].append((int(idx[j]), streams[j]))


def window(st: dict, seconds: float, run, phase: str) -> dict:
    s = loops.closed_window(lambda: step(st, run), seconds, run, phase)
    return {"encode_MBps": run.totals(phase)[1] / 1e6 / s}


def verify(st: dict, run):
    getattr(st.pop("gen"), "close", lambda: None)()
    wrong = loops.streams_differ(st["kept"], st["pool"], st["conf"],
                                 st["cell"]["check_streams"], run.rng(3))
    return ({"streams_differ": (wrong, 0), "tiles_missing": (st["missing"], 0)},
            st["attempted"], st["missing"])
