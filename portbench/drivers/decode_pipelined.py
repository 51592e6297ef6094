"""Driver: qb3_tpu_torch.pipeline.decode_tiles_pipelined, a closed loop of
batches of same-shape sidecar-bearing streams (the bulk decode of an
archive's tiles).

Set-up encodes the pool's rasters once with the program's batch encode in
the configuration's mode and sidecar; those streams are the window's
inputs.  A batch counts when its arrays reach the host.  One tile of each
batch, at a seeded position, is copied for the check.
"""

from __future__ import annotations

import collections

from portbench import loops, registry
from portbench.drivers import decode_foreign
from portbench.traffic import Traffic

# the entry the window drives, and what goes in and out of it (faults.py)
ENTRY = "qb3_tpu_torch.pipeline:decode_tiles_pipelined"
SHAPE = "array_batches"


def setup(cell: dict, run) -> dict:
    import qb3_tpu_torch as q
    from qb3_tpu_torch import pipeline

    conf, tr = cell["config"], cell["traffic"]
    traffic = Traffic(tr, run.rng(2))
    pool = registry.rasters(conf, traffic.pool, run.rng(1))
    streams = []
    for i in range(0, len(pool), traffic.batch):
        streams += q.encode_tiles(pool[i: i + traffic.batch], mode=loops.MODES[conf["mode"]],
                                  coreband=conf.get("coreband"),
                                  index=conf.get("index") or False, device=run.device)
    sent = collections.deque()

    def feed():
        for _, idx in traffic.batches():
            sent.append(idx)
            yield [streams[j] for j in idx]

    st = dict(pool=pool, conf=conf, sizes=[len(s) for s in streams], sent=sent, kept=[], missing=0,
              attempted=0, pos=run.rng(4),
              gen=pipeline.decode_tiles_pipelined(feed(), device=run.device))
    for _ in range(cell["warmup_batches"]):
        decode_foreign.step(st, run)
    return st


window = decode_foreign.window
verify = decode_foreign.verify
