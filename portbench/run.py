"""Run one cell of the benchmark on this machine's card and print its result.

    python3 -m portbench.run --workload rgb8-ftl-ingest --seed 7 --seconds 20 --trace 0

From the root of a checkout.  It makes its inputs from --seed, sets up
(imports, the CUDA context, the program's kernel library, the inputs, a
warm-up of the cell's own shapes: setup_s), measures for --seconds, checks
what the window produced against the plain reference, and prints one JSON
object as the last line of standard output: the cell's end-to-end metrics
with --trace 0, its per-layer metrics (and the device's busy and traced
seconds, and a breakdown) with --trace 1.  The numbers the check compared
come last, each beside its limit, on standard error too.  Without a CUDA
card it exits with 2 and prints no result; it never times the CPU.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import harness, registry

    chips = registry.workload(args.workload)["chips"]
    have = harness.cuda_device_count()
    if have < chips:
        print(f"refused: the cell needs {chips} CUDA device(s), this machine has {have}",
              file=sys.stderr)
        return 2
    out = harness.execute(args.workload, args.seed, args.seconds, bool(args.trace),
                          t_start=T_START)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
