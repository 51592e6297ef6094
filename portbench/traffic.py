"""The one generator of every traffic mix.

A mix is a data file, portbench/traffic/<name>.json, of parameters:

  loop      "closed": the next batch is sent when the last one has come
            back; "open": requests are due at seeded arrival times,
            whatever the program's backlog
  pool      distinct tiles (or streams) a run draws from
  batch     tiles a batch (closed loops)
  arrivals  "poisson" (open loops): exponential gaps at the cell's rate:
            one sample path for every run, cut into blocks of block_s
            seconds, the blocks in a seeded order
  block_s   seconds of arrivals a block (open loops)

A closed loop's batch is `batch` consecutive entries of a seeded cyclic
arrangement of the pool, from a uniform offset, so every batch holds
distinct tiles and is one contiguous slice of the pool laid out twice
(no copy is made to send it).  Every seed gives the same sizes, counts
and rates; the seed only changes which tiles come when.  An open loop's
tail depends on its bursts, so every run meets the same bursts, in another
order.
"""

from __future__ import annotations

import numpy as np

PATH_SEED = 20260101  # the one sample path of arrivals that every run cuts up


class Traffic:
    def __init__(self, params: dict, rng: np.random.Generator):
        self.params = params
        self.pool = int(params["pool"])
        self.batch = int(params.get("batch", 1))
        self.rng = rng
        perm = rng.permutation(self.pool)
        self.arrangement = np.concatenate([perm, perm])  # pool index at each slot

    def batches(self):
        """Closed loop: endless (offset, pool indices) of each batch."""
        while True:
            off = int(self.rng.integers(0, self.pool))
            yield off, self.arrangement[off: off + self.batch]

    def arrivals(self, seconds: float, rate: float):
        """Open loop: (due times in (0, seconds], pool index of each):
        round(rate * seconds) requests whose gaps are the exponential law's
        quantiles at (i + 1/2) / n in PATH_SEED's order, scaled to sum to
        `seconds`; the path is cut into blocks of block_s seconds, which
        come in a seeded order.  Seeds differ in the order of the blocks and
        in the tiles alone."""
        n = max(1, round(rate * seconds))
        gaps = -np.log1p(-(np.arange(n) + 0.5) / n)
        gaps = np.random.default_rng(PATH_SEED).permutation(gaps * (seconds / gaps.sum()))
        per = max(1, round(rate * float(self.params.get("block_s", seconds))))
        blocks = [gaps[i: i + per] for i in range(0, n, per)]
        gaps = np.concatenate([blocks[i] for i in self.rng.permutation(len(blocks))])
        return np.cumsum(gaps), self.rng.integers(0, self.pool, n)
