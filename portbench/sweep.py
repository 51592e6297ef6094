"""Find the highest rate the serve cell's program sustains: the knee.

    python3 -m portbench.sweep --workload rgb8-ftl-serve --seed 11 --seconds 10 \\
        --rates 100,120,140,160,180,200 --limit-ms 20

One process, one set-up; then for each rate one open-loop window of the
cell's traffic at that rate.  A rate is sustained when its p95 latency
meets the limit, every request due in the window was answered within
0.1 s of the last one's arrival (the backlog left at the window's end),
and the requests of the window's last fifth waited no longer on average
than twice those of its second fifth (a backlog that grows through the
window fails either).  Prints one line a rate and last the knee (the
highest rate sustained with every lower rate sustained too) and four
fifths of it, the rate a cell below capacity is offered.  Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def sustained(lat: list, limit_s: float) -> tuple[bool, float]:
    """(whether the window kept up within the limit, last fifth's mean wait
    / second fifth's)."""
    lat = np.asarray(lat)
    n = len(lat)
    second, last = lat[n // 5: 2 * n // 5].mean(), lat[4 * n // 5:].mean()
    ratio = float(last / second)
    ok = ratio <= 2.0 and lat[-1] <= 0.1 and np.percentile(lat, 95) <= limit_s
    return bool(ok), ratio


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", default="rgb8-ftl-serve")
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--seconds", type=float, default=10)
    ap.add_argument("--rates", default="100,120,140,160,180,200")
    ap.add_argument("--limit-ms", type=float, default=20.0,
                    help="the p95 latency a sustained rate meets")
    args = ap.parse_args(argv)

    from portbench import harness, registry

    if harness.cuda_device_count() < 1:
        print("refused: no CUDA device", file=sys.stderr)
        return 2
    cell = registry.cell(args.workload)
    driver = registry.driver(cell["driver"])
    run = harness.Run(args.seed, "cuda", False)
    st = driver.setup(cell, run)
    rows = []
    for rate in sorted(float(r) for r in args.rates.split(",")):
        st["rate"] = rate
        t0 = time.perf_counter()
        vals = driver.window(st, args.seconds, run, "window")
        wall = time.perf_counter() - t0
        ok, ratio = sustained(st["latencies"], args.limit_ms / 1e3)
        row = dict(rate=rate, sustained=ok, trend=ratio, wall_s=wall,
                   drain_s=st["latencies"][-1],
                   p50_ms=harness.percentile(st["latencies"], 50) * 1e3,
                   p95_ms=vals["tile_p95_ms"],
                   max_ms=max(st["latencies"]) * 1e3, requests=len(st["latencies"]))
        rows.append(row)
        print(json.dumps(row), flush=True)
    knee = None
    for row in rows:
        if not row["sustained"]:
            break
        knee = row["rate"]
    print(json.dumps({"knee_per_s": knee, "offered_per_s": 0.8 * knee if knee else None}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
