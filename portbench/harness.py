"""One run of one cell: set-up, the measured window, the check, the result.

The cell's files are found by name (registry.py); the driver named in the
cell's file does the cell's own work (drivers/<driver>.py: setup, window,
verify); the per-layer metrics are read by the readers of metrics/ from
what a run records here:

  * ticks: each unit of work the window completed (tiles, raster bytes,
    stream bytes, host clock), per phase ("window", and "slice": the
    profiled stretch of a traced run);
  * spans: host-clock intervals around functions of the program, wrapped
    from outside for the traced run (metrics' SPANS) or opened by a
    driver (Run.span);
  * samples: lists a driver keeps (request latencies, service times);
  * profile: the traced slice's device records (torch.profiler), reduced
    to the device-active time, its share of the slice's wall time, the
    device operations by time and the idle gaps by host stage;
  * host: what the card machine's host exposed over the window and, in a
    traced run, the host yardstick timed after it (host.py): the result's
    device.host.

Nothing here runs at import time; the program is imported by the drivers.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import statistics
import sys
import time

import numpy as np

from . import host, registry

# module names whose presence after the window refuses the run: the JAX
# package and JAX itself (top-level names compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "qb3_tpu")
SLICE_S = 2.0  # the profiled stretch of a traced run, after its window
_SENTINELS = 16  # kernels that open a profile (see _profile)
_SENTINEL_KERNEL = "spin_kernel"  # torch.cuda._sleep's
_PAD_S = 0.02


class Run:
    """What one run records (see the module docstring)."""

    def __init__(self, seed: int, device: str, tracing: bool):
        self.seed = seed
        self.device = device
        self.tracing = tracing
        self.phase = "setup"
        self.ticks = {"window": [], "slice": []}
        self.spans = {}
        self.samples = {}
        self.profile = None
        self.host = {}

    def rng(self, *tag: int) -> np.random.Generator:
        """A generator drawn from the run's seed and a tag of its own."""
        return np.random.default_rng(np.random.SeedSequence([self.seed, *tag]))

    def begin(self, phase: str) -> float:
        """Enter a phase ("window", "slice") -> the host clock."""
        self.phase = phase
        return time.perf_counter()

    def done(self, tiles: int, raw_bytes: int, coded_bytes: int) -> None:
        """A unit of work completed now."""
        if self.phase in self.ticks:
            self.ticks[self.phase].append((time.perf_counter(), tiles, raw_bytes, coded_bytes))

    def totals(self, phase: str = "window"):
        """(tiles, raw bytes, coded bytes) completed in a phase."""
        t = self.ticks[phase]
        return tuple(sum(x[i] for x in t) for i in (1, 2, 3))

    def sample(self, name: str, value: float) -> None:
        if self.phase == "window":
            self.samples.setdefault(name, []).append(value)

    @contextlib.contextmanager
    def span(self, name: str):
        """Host-clock span around a stage, kept per phase; in a traced run
        also a profiler range named "pb:<name>", which names idle gaps."""
        rf = _record_function(name) if self.tracing else contextlib.nullcontext()
        t0 = time.perf_counter()
        with rf:
            try:
                yield
            finally:
                self.spans.setdefault((self.phase, name), []).append(
                    (t0, time.perf_counter()))

    def span_seconds(self, name: str, phase: str = "window") -> float | None:
        s = self.spans.get((phase, name))
        return sum(b - a for a, b in s) if s else None


def _record_function(name: str):
    from torch.profiler import record_function

    return record_function("pb:" + name)


def wrap_spans(run: Run, targets: dict) -> list:
    """Wrap each "module:function" of targets (span name -> list of them)
    in run.span from outside the program -> what restore() puts back."""
    saved = []
    for name, where in targets.items():
        for spec in where:
            mod_name, attr = spec.split(":")
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, attr)

            def timed(*a, _fn=fn, _name=name, **kw):
                with run.span(_name):
                    return _fn(*a, **kw)

            saved.append((mod, attr, fn))
            setattr(mod, attr, functools.wraps(fn)(timed))
    return saved


def restore(saved: list) -> None:
    for mod, attr, fn in reversed(saved):
        setattr(mod, attr, fn)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def _union_s(spans) -> float:
    """Seconds covered by (start, end) us intervals."""
    total, reach = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > reach:
            total += b - max(a, reach)
            reach = b
    return total / 1e6


def _profile(run: Run, fn) -> None:
    """fn() under torch.profiler, reduced into run.profile.

    On the H100 the profiler keeps no record of a profile's first few
    kernels once a process is about a minute old, so 16 sentinel kernels
    open the profile and are left out (qb3_tpu_torch/benchutil.py's
    device_profile, whose arithmetic this copies)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(_SENTINELS):
            torch.cuda._sleep(100)
        torch.cuda.synchronize()
        time.sleep(_PAD_S)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        time.sleep(_PAD_S)
    events = [(e.device_type == DeviceType.CUDA, e.name, e.time_range.start,
               e.time_range.end) for e in prof.events()]
    run.profile = reduce_events(events, wall)


def reduce_events(events, wall: float) -> dict:
    """(on the device?, name, start us, end us) records of a profile and its
    wall seconds -> active_s (the union of the device records), busy_s,
    wall_s, per_op (device seconds by name) and gaps (idle seconds by the
    innermost host stage, "pb:<name>", open at each gap's middle)."""
    per_op, dev, ranges = {}, [], []
    for on_device, name, a, b in events:
        if on_device:
            # the sentinels, and the device-side copies of the host ranges
            # (a record_function range shows on the device's timeline too)
            if _SENTINEL_KERNEL in name or name.startswith("pb:"):
                continue
            per_op[name] = per_op.get(name, 0.0) + (b - a) / 1e6
            dev.append((a, b))
        elif name.startswith("pb:"):
            ranges.append((a, b, name[3:]))
    if not dev:
        raise RuntimeError("the profile recorded no device activity")
    active = _union_s(dev)
    gaps = {}
    reach = None
    for a, b in sorted(dev):
        if reach is not None and a > reach:
            mid = (a + reach) / 2
            inside = [h for h in ranges if h[0] <= mid <= h[1]]
            name = min(inside, key=lambda h: h[1] - h[0])[2] if inside else "other"
            gaps[name] = gaps.get(name, 0.0) + (a - reach) / 1e6
        reach = b if reach is None else max(reach, b)
    return dict(active_s=active, wall_s=wall, per_op=per_op, gaps=gaps,
                busy_s=min(active, wall))


def cuda_device_count() -> int:
    import torch

    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def execute(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
            root: str = ".", overrides: dict | None = None, faults=None,
            t_start: float | None = None) -> dict:
    """One run -> the result line's object.  device "cpu", overrides and
    faults (faults.py) are for the tests and the control runs, which break
    the program under the window; the command line takes none of them
    (run.py)."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = registry.cell(workload, root, overrides)
    driver = registry.driver(cell["driver"])
    metrics = registry.per_layer(workload, root) if trace else []
    run = Run(seed, device, trace)
    bus_id = host.card_bus_id() if device == "cuda" else None
    # the tests' faults replace the entry the window drives before set-up
    saved = faults(cell, driver) if faults else []
    try:
        # wrapped before set-up, as some entries bind their stages when
        # they are called; the set-up's spans are kept apart by phase
        if trace:
            targets = {}
            for m in metrics:
                targets.update(getattr(m.module, "SPANS", {}))
            saved += wrap_spans(run, targets)
        state = driver.setup(cell, run)
        if device == "cuda":
            import torch

            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t_start
        before = host.counters()
        values = driver.window(state, seconds, run, "window")
        after = host.counters()
        if trace and device == "cuda":
            _profile(run, lambda: driver.window(state, SLICE_S, run, "slice"))
        run.host = dict(host.static_facts(bus_id=bus_id), **host.window_facts(before, after),
                        raw_MBps_by_sixth=host.rate_by_part(run.ticks["window"], before["t"],
                                                            after["t"]))
        if trace:
            seed_probe = int(run.rng(9).integers(2**63))
            run.host["probe"] = host.probe(seed_probe, device == "cuda")
    finally:
        restore(saved)
    found = forbidden_modules()
    if found:
        raise SystemExit(f"refused: loaded after the window: {', '.join(found)}")
    peak, kind = 0, device
    if device == "cuda":
        import torch

        torch.cuda.synchronize()
        peak = int(torch.cuda.max_memory_allocated())
        kind = torch.cuda.get_device_name(0)
    checks, attempted, failed = driver.verify(state, run)
    correct = all(v <= lim for v, lim in checks.values()) and failed == 0
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed)}
    if trace:
        mvals = {}
        for m in metrics:
            v = m.module.read(run)
            if v is not None:
                mvals[m.name] = {"value": float(v), "unit": m.unit}
        out["metrics"] = mvals
    else:
        # a metric "<quantity>.<cells>" is the driver's <quantity> in the
        # cells it names (encode_MBps.best: encode_MBps in a best-mode cell)
        e2e = registry.end_to_end(workload, root)
        mvals = {m.name: {"value": float(values[m.name.split(".")[0]]), "unit": m.unit}
                 for m in e2e if m.name.split(".")[0] in values}
        mvals["setup_s"] = {"value": setup_s, "unit": "s"}
        out["metrics"] = mvals
    dev = {"platform": "gpu" if device == "cuda" else device, "kind": kind, "count": 1,
           "memory_peak_bytes": peak}
    if trace and run.profile:
        dev["busy_s"] = run.profile["busy_s"]
        dev["window_s"] = run.profile["wall_s"]
        ops = sorted(run.profile["per_op"].items(), key=lambda x: -x[1])[:10]
        ops = [(short_name(k), v) for k, v in ops]
        gaps = sorted(run.profile["gaps"].items(), key=lambda x: -x[1])[:10]
        out["breakdown"] = {"device_ops": [[k, v] for k, v in ops],
                            "idle_gaps": [[k, v] for k, v in gaps]}
    dev["host"] = run.host
    out["device"] = dev
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return out


def short_name(kernel: str, n: int = 120) -> str:
    """A device operation's name without its return type, cut to n
    characters (template arguments make some thousands long)."""
    name = kernel[5:] if kernel.startswith("void ") else kernel
    return name if len(name) <= n else name[: n - 3] + "..."


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between order
    statistics."""
    return float(np.percentile(np.asarray(values, np.float64), q))


def median(values) -> float:
    return float(statistics.median(values))
