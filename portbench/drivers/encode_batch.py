"""Driver: qb3_tpu_torch.batch.encode_tiles, a closed loop of same-shape
tile batches, one call after another (the producer of a tile service).

A batch counts when its call returns its streams.  One stream of each
batch, at a seeded position, is kept for the check.
"""

from __future__ import annotations

import collections

from portbench import loops, registry
from portbench.drivers import encode_pipelined
from portbench.traffic import Traffic


# the entry the window drives, and what goes in and out of it (faults.py)
ENTRY = "qb3_tpu_torch.batch:encode_tiles"
SHAPE = "stream_batch"


def setup(cell: dict, run) -> dict:
    from qb3_tpu_torch import batch

    conf, tr = cell["config"], cell["traffic"]
    traffic = Traffic(tr, run.rng(2))
    pool = registry.rasters(conf, traffic.pool, run.rng(1))
    laid = pool[traffic.arrangement]
    draws = traffic.batches()
    sent = collections.deque()

    def call():
        off, idx = next(draws)
        sent.append(idx)
        return batch.encode_tiles(laid[off: off + traffic.batch],
                                  mode=loops.MODES[conf["mode"]],
                                  coreband=conf.get("coreband"),
                                  index=conf.get("index") or False, device=run.device)

    st = dict(pool=pool, conf=conf, cell=cell, sent=sent, kept=[], missing=0, attempted=0,
              pos=run.rng(4), tile_bytes=pool[0].nbytes,
              gen=iter(call, None))
    for _ in range(cell["warmup_batches"]):
        encode_pipelined.step(st, run)
    return st


window = encode_pipelined.window
verify = encode_pipelined.verify
