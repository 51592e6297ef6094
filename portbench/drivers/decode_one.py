"""Driver: qb3_tpu_torch.decode(stream), one request at a time by one
worker, first in first out, under open-loop arrivals (a tile server
answering map clients).

Set-up encodes the pool's rasters once with the program's batch encode;
those streams are the requests' inputs.  Each request is due at its
arrival time; its latency runs from then to the decoded array on the host,
so a stall counts against every request queued behind it.  A seeded share
of the answers (the cell's check_share) is kept for the check.
"""

from __future__ import annotations

import time

from portbench import harness, loops, registry
from portbench.traffic import Traffic


# the entry the window drives, and what goes in and out of it (faults.py)
ENTRY = "qb3_tpu_torch:decode"
SHAPE = "array_one"


def setup(cell: dict, run) -> dict:
    import qb3_tpu_torch as q

    conf, tr = cell["config"], cell["traffic"]
    traffic = Traffic(tr, run.rng(2))
    pool = registry.rasters(conf, traffic.pool, run.rng(1))
    streams = []
    for i in range(0, len(pool), 128):
        streams += q.encode_tiles(pool[i: i + 128], mode=loops.MODES[conf["mode"]],
                                  coreband=conf.get("coreband"),
                                  index=conf.get("index") or False, device=run.device)
    st = dict(pool=pool, conf=conf, streams=streams, traffic=traffic, rate=cell["rate_per_s"],
              share=cell["check_share"], keep=run.rng(4), kept=[], failed=0, attempted=0,
              decode=q.decode, device=run.device)
    for i in range(cell["warmup_requests"]):
        q.decode(streams[i % len(streams)], device=run.device)
    return st


def window(st: dict, seconds: float, run, phase: str) -> dict:
    due, idx = st["traffic"].arrivals(seconds, st["rate"])

    def serve(i):
        j = int(idx[i])
        t0 = time.perf_counter()
        try:
            with run.span("decode"):
                img, _ = st["decode"](st["streams"][j], device=st["device"])
        except Exception:  # a failed request: counted, and late by its time
            img = None
            if phase == "window":
                st["failed"] += 1
        t1 = time.perf_counter()
        run.sample("service_s", t1 - t0)
        run.done(1, st["pool"][j].nbytes, len(st["streams"][j]))
        if phase == "window":
            st["attempted"] += 1
            if img is not None and st["keep"].random() < st["share"]:
                st["kept"].append((j, img))

    lat = st["latencies"] = loops.open_window(serve, due, run, phase)
    return {"tile_p95_ms": harness.percentile(lat, 95) * 1e3}


def verify(st: dict, run):
    wrong = loops.arrays_differ(st["kept"], st["pool"], st["conf"])
    return ({"tiles_differ": (wrong, 0), "requests_failed": (st["failed"], 0)},
            st["attempted"], st["failed"])
