"""Read the check's numbers of a cell with the window's entry broken
(faults.py), on the card at the cell's own size, seed after seed.

    python3 -m portbench.control --workload rgb8-ftl-ingest --kind control \\
        --seeds 11,12,13 --seconds 5

One process; each seed is a whole run (set-up, window, check) with the
fault installed, and prints one JSON line: the seed, correct, and each
compared number beside its limit.  The benchmark's own runs never install
a fault.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--kind", default="control")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5)
    args = ap.parse_args(argv)

    from portbench import faults, harness

    if harness.cuda_device_count() < 1:
        print("refused: no CUDA device", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        out = harness.execute(args.workload, seed, args.seconds, False,
                              faults=faults.install(args.kind))
        print(json.dumps({"workload": args.workload, "kind": args.kind, "seed": seed,
                          "correct": out["correct"], "attempted": out["attempted"],
                          "failed": out["failed"], "checks": out["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
