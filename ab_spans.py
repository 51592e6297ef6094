"""The program's own spans (qb3_tpu_torch.profiling) in a portbench cell, on
the card: a per-stage table from traced runs, and untraced runs with the
tracer on or off, for its cost.

    python3 ab_spans.py table --workload rgb8-ftl-ingest --seeds 11 12 13
        # one traced run a seed (portbench's --trace 1, 30 s windows): its
        # result line, then each span's host ms, device ms and host self
        # ms (its duration less its children's) per tile over the window,
        # and pipeline.finish / batch.finish beside the harness's
        # host_finish_ms_per_tile.* of the same run
    python3 ab_spans.py cost --workload rgb8-ftl-ingest --seed 11 --tracer on
        # one untraced run (portbench's --trace 0) with the tracer switched
        # on (or off) before set-up: its result line, and with the tracer
        # on the table of its measured window, as for table

Run from the root of a checkout that holds BENCHMARK.json and portbench/;
each run's records go to ab/spans/<workload>.<seed>.json (git-ignored).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

OUT = os.path.join("ab", "spans")


def self_ms(r, children) -> float:
    """A record's host ms less the part of its interval its children cover."""
    covered, reach = 0, r["t0_ns"]
    for c in sorted(children, key=lambda c: c["t0_ns"]):
        a, b = max(c["t0_ns"], reach), min(c["t1_ns"], r["t1_ns"])
        if b > a:
            covered += b - a
            reach = b
    return r["host_ms"] - covered / 1e6


def stage_table(records) -> dict:
    """name -> {spans, tiles, host, device, self}: ms per tile (device None
    where a span has no device time)."""
    kids = {}
    for r in records:
        kids.setdefault(r["parent"], []).append(r)
    out = {}
    for name in dict.fromkeys(r["name"] for r in records):
        rs = [r for r in records if r["name"] == name]
        tiles = sum(r["tiles"] for r in rs) or 1
        dev = None if any(r["device_ms"] is None for r in rs) else \
            sum(r["device_ms"] for r in rs) / tiles
        out[name] = dict(spans=len(rs), tiles=tiles,
                         host=sum(r["host_ms"] for r in rs) / tiles, device=dev,
                         self=sum(self_ms(r, kids.get(r["id"], [])) for r in rs) / tiles)
    return out


def kept_runs() -> list:
    """The harness's runs, each appended as it is made."""
    from portbench import harness

    runs = []

    class KeptRun(harness.Run):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            runs.append(self)

    harness.Run = KeptRun
    return runs


def report(workload: str, seed: int, out: dict, window: list) -> None:
    """The window's stage table, printed and kept with the records."""
    from qb3_tpu_torch import profiling

    stages = stage_table(window)
    with open(os.path.join(OUT, f"{workload}.{seed}.json"), "w") as f:
        json.dump(dict(result=out, stages=stages, records=window), f)
    print(f"seed {seed}: {'stage':22s} {'spans':>6s} {'host':>9s} {'device':>9s} "
          f"{'self':>9s}  (ms a tile)")
    for name, s in stages.items():
        dev = "-" if s["device"] is None else f"{s['device']:.5f}"
        print(f"seed {seed}: {name:22s} {s['spans']:6d} {s['host']:9.5f} {dev:>9s} "
              f"{s['self']:9.5f}")
    for inner, outer in (("pipeline.finish", "host_finish_ms_per_tile.encode"),
                         ("batch.finish", "host_finish_ms_per_tile.best")):
        if inner in stages and outer in out["metrics"]:
            a, b = stages[inner]["host"], out["metrics"][outer]["value"]
            print(f"seed {seed}: {inner} {a:.5f} vs {outer} {b:.5f} ms a tile "
                  f"({100 * (a / b - 1):+.2f}%)")
    print(f"seed {seed}: cap_misses {profiling.counters()['pipeline.cap_misses']}", flush=True)


def table(args) -> None:
    from portbench import harness, spans

    from qb3_tpu_torch import profiling

    runs = kept_runs()
    for seed in args.seeds:
        profiling.disable()  # a fresh ring a run
        t0 = time.perf_counter()
        out = harness.execute(args.workload, seed, args.seconds, True, t_start=t0)
        print(json.dumps(out))
        report(args.workload, seed, out, spans.in_window(profiling.records(), runs[-1]))


def cost(args) -> None:
    from portbench import harness, spans

    from qb3_tpu_torch import profiling

    runs = kept_runs()
    if args.tracer == "on":
        profiling.enable()
    out = harness.execute(args.workload, args.seed, args.seconds, False, t_start=T_START)
    out["tracer"] = args.tracer
    out["spans"] = len(profiling.records()) if args.tracer == "on" else 0
    print(json.dumps(out))
    if args.tracer == "on":
        report(args.workload, args.seed, out, spans.in_window(profiling.records(), runs[-1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("table")
    t.add_argument("--seeds", type=int, nargs="+", required=True)
    c = sub.add_parser("cost")
    c.add_argument("--seed", type=int, required=True)
    c.add_argument("--tracer", choices=("on", "off"), required=True)
    for p in (t, c):
        p.add_argument("--workload", required=True)
        p.add_argument("--seconds", type=float, default=30.0)
    args = ap.parse_args(argv)
    os.makedirs(OUT, exist_ok=True)
    (table if args.cmd == "table" else cost)(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
