"""The card machine's host: what it exposes beside each run, and a fixed
host workload (the yardstick).

A host-paced cell runs as fast as the host's cores let it, so each run
records, by reading only, what could make one run's host slower than
another's (the result's device.host):

  * the process: its allowed cores, os.cpu_count(), torch's intra-op and
    inter-op threads;
  * a CPU quota: the tightest cgroup v2 cpu.max along the process's
    cgroup path, and the change of its cpu.stat's nr_throttled and
    throttled_usec over the window;
  * neighbours: the change of /proc/pressure/{cpu,memory}'s "some" totals
    over the window;
  * placement: the card's NUMA node (its PCI device's numa_node) and each
    allowed core's node;
  * the cores' speed: the mean "cpu MHz" of the allowed cores before and
    after the window;
  * the window's pace: its raw MB/s in each sixth of it (rate_by_part).

Nothing here writes under /proc or /sys or changes the process.  Every
reader takes `root`, the directory /proc and /sys are under (the tests
point it at a fixture tree); a file that is absent or unreadable reads
None.

probe() times the yardstick in a fresh process (python3 -m portbench.host),
with the cores and the environment this process started with and a fixed
thread count, so that nothing the program sets (its threads, its
affinity, its allocator's state) moves it.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = "/"
# the yardstick: one batch of 128 u8 512x512x3 tiles copied into a
# page-locked buffer (the pipeline's staging), and about one batch's
# stream bytes joined from 128 parts (the containers)
PROBE_BYTES = 100_663_296
PROBE_PARTS = 128
PROBE_PART_BYTES = 426_000
PROBE_REPEATS = 5
PROBE_THREADS = 4
# taken when the harness is imported, before any of the program is
ENV = dict(os.environ)
CORES = sorted(os.sched_getaffinity(0))


def _read(root: str, path: str) -> str | None:
    try:
        with open(os.path.join(root, path.lstrip("/"))) as f:
            return f.read()
    except OSError:
        return None


def cpulist(text: str) -> list[int]:
    """ "0-3,8,10-11" -> [0, 1, 2, 3, 8, 10, 11]."""
    out = []
    for part in text.strip().split(","):
        if part:
            a, _, b = part.partition("-")
            out += range(int(a), int(b or a) + 1)
    return out


def _cgroup_dirs(root: str) -> list[str]:
    """The process's cgroup v2 directories, leaf first, or []."""
    for line in (_read(root, "/proc/self/cgroup") or "").splitlines():
        hierarchy, ctrls, path = line.split(":", 2)
        if hierarchy == "0" and not ctrls:
            parts = [p for p in path.strip().split("/") if p]
            return ["/".join(["/sys/fs/cgroup", *parts[:i]])
                    for i in range(len(parts), -1, -1)]
    return []


def cpu_quota(root: str = ROOT) -> dict | None:
    """The tightest cpu.max along the process's cgroup path ->
    {"cores": quota / period, "at": its file}, or None where none sets one."""
    best = None
    for d in _cgroup_dirs(root):
        text = _read(root, d + "/cpu.max")
        if not text or text.split()[0] == "max":
            continue
        quota, period = (int(x) for x in text.split()[:2])
        if period > 0 and (best is None or quota / period < best["cores"]):
            best = {"cores": quota / period, "at": d + "/cpu.max"}
    return best


def throttling(root: str = ROOT) -> dict | None:
    """The process's cgroup's {"nr_throttled", "throttled_usec"} so far
    (cpu.stat), or None."""
    dirs = _cgroup_dirs(root)
    text = _read(root, dirs[0] + "/cpu.stat") if dirs else None
    kv = dict(line.split()[:2] for line in (text or "").splitlines() if len(line.split()) >= 2)
    if "nr_throttled" not in kv or "throttled_usec" not in kv:
        return None
    return {"nr_throttled": int(kv["nr_throttled"]), "throttled_usec": int(kv["throttled_usec"])}


def pressure(root: str, what: str) -> int | None:
    """/proc/pressure/<what>'s "some" total, in us."""
    for line in (_read(root, f"/proc/pressure/{what}") or "").splitlines():
        kind, *fields = line.split()
        if kind == "some":
            return int(dict(f.split("=") for f in fields)["total"])
    return None


def cpu_mhz(cores, root: str = ROOT) -> float | None:
    """The mean "cpu MHz" of /proc/cpuinfo over the given cores."""
    mhz, cpu = {}, None
    for line in (_read(root, "/proc/cpuinfo") or "").splitlines():
        key, _, val = line.partition(":")
        key = key.strip()
        if key == "processor":
            cpu = int(val)
        elif key == "cpu MHz" and cpu is not None:
            mhz[cpu] = float(val)
    vals = [mhz[c] for c in cores if c in mhz]
    return sum(vals) / len(vals) if vals else None


def node_cpus(root: str = ROOT) -> dict[int, list[int]]:
    """NUMA node -> its cores, from /sys/devices/system/node/node*/cpulist."""
    try:
        names = os.listdir(os.path.join(root, "sys/devices/system/node"))
    except OSError:
        return {}
    out = {}
    for name in names:
        if name.startswith("node") and name[4:].isdigit():
            text = _read(root, f"/sys/devices/system/node/{name}/cpulist")
            if text is not None:
                out[int(name[4:])] = cpulist(text)
    return out


def card_bus_id(index: int = 0) -> str | None:
    """The CUDA device's PCI address ("0000:17:00.0") from torch's device
    properties, or None where they do not carry it."""
    import torch

    p = torch.cuda.get_device_properties(index)
    if not hasattr(p, "pci_bus_id"):
        return None
    return f"{getattr(p, 'pci_domain_id', 0):04x}:{p.pci_bus_id:02x}:{p.pci_device_id:02x}.0"


def card_node(bus_id: str | None, root: str = ROOT) -> int | None:
    """The card's NUMA node, or None where the machine does not say."""
    text = _read(root, f"/sys/bus/pci/devices/{bus_id}/numa_node") if bus_id else None
    return int(text) if text is not None and int(text) >= 0 else None


def _affinity() -> list[int]:
    return sorted(os.sched_getaffinity(0))


def counters(root: str = ROOT) -> dict:
    """The cumulative readings whose change over a window is a fact."""
    return dict(t=time.perf_counter(), throttle=throttling(root),
                psi_cpu=pressure(root, "cpu"), psi_memory=pressure(root, "memory"),
                mhz=cpu_mhz(_affinity(), root))


def _delta(a, b):
    return None if a is None or b is None else b - a


def window_facts(before: dict, after: dict) -> dict:
    """What changed between two counters() readings around a window."""
    a, b = before["throttle"] or {}, after["throttle"] or {}
    return dict(window_s=after["t"] - before["t"],
                nr_throttled=_delta(a.get("nr_throttled"), b.get("nr_throttled")),
                throttled_usec=_delta(a.get("throttled_usec"), b.get("throttled_usec")),
                psi_cpu_some_us=_delta(before["psi_cpu"], after["psi_cpu"]),
                psi_memory_some_us=_delta(before["psi_memory"], after["psi_memory"]),
                mhz_before=before["mhz"], mhz_after=after["mhz"])


def rate_by_part(ticks, t0: float, t1: float, parts: int = 6) -> list:
    """Raw MB/s completed in each of `parts` equal stretches of a window
    (ticks: (time, tiles, raw bytes, coded bytes)): whether a run's pace
    drifts inside its window or is set for the whole process."""
    edges = [t0 + (t1 - t0) * i / parts for i in range(parts + 1)]
    out = []
    for a, b in zip(edges, edges[1:]):
        raw = sum(x[2] for x in ticks if a < x[0] <= b)
        out.append(raw / 1e6 / (b - a) if b > a else None)
    return out


def static_facts(root: str = ROOT, bus_id: str | None = None) -> dict:
    """What the host is, read once a run."""
    import torch

    nodes = node_cpus(root)
    allowed = _affinity()
    return dict(affinity=allowed, cpu_count=os.cpu_count(),
                threads=torch.get_num_threads(), interop_threads=torch.get_num_interop_threads(),
                cpu_quota=cpu_quota(root), card_bus_id=bus_id,
                card_node=card_node(bus_id, root),
                core_nodes={c: n for n, cs in nodes.items() for c in cs if c in allowed})


def probe_ms(rng: np.random.Generator, pin: bool, repeats: int = PROBE_REPEATS) -> dict:
    """The yardstick, made from rng: `repeats` times a torch copy_ of
    PROBE_BYTES into a page-locked tensor (pin) and a b"".join of
    PROBE_PARTS arrays' tobytes() -> the median ms of each part and of
    their sum, which host_probe_ms.* reads.  Run it through probe()."""
    import torch

    src = torch.from_numpy(np.frombuffer(rng.bytes(PROBE_BYTES), np.uint8).copy())
    dst = torch.empty(PROBE_BYTES, dtype=torch.uint8, pin_memory=pin)
    parts = [np.frombuffer(rng.bytes(PROBE_PART_BYTES), np.uint8) for _ in range(PROBE_PARTS)]
    copy, join = [], []
    for _ in range(repeats):
        t0 = time.perf_counter()
        dst.copy_(src)
        t1 = time.perf_counter()
        joined = b"".join(p.tobytes() for p in parts)
        t2 = time.perf_counter()
        copy.append((t1 - t0) * 1e3)
        join.append((t2 - t1) * 1e3)
    assert len(joined) == PROBE_PARTS * PROBE_PART_BYTES and torch.equal(dst[-64:], src[-64:])
    return {"ms": statistics.median(a + b for a, b in zip(copy, join)),
            "copy_ms": statistics.median(copy), "join_ms": statistics.median(join)}


def probe(seed: int, pin: bool, timeout: float = 120) -> dict:
    """probe_ms() in a fresh process started beside portbench/, on
    CORES, with ENV and PROBE_THREADS intra-op threads; waits for it ->
    probe_ms()'s readings and the threads and cores it ran on."""
    env = dict(ENV, OMP_NUM_THREADS=str(PROBE_THREADS))
    cmd = [sys.executable, "-m", "portbench.host", str(seed), str(int(pin)),
           ",".join(map(str, CORES))]
    beside = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    done = subprocess.run(cmd, cwd=beside, env=env, capture_output=True, text=True,
                          timeout=timeout)
    if done.returncode != 0:
        raise RuntimeError(f"the host probe failed ({done.returncode}): {done.stderr[-2000:]}")
    return json.loads(done.stdout.splitlines()[-1])


def _main(argv: list[str]) -> None:
    seed, pin, cores = int(argv[0]), bool(int(argv[1])), cpulist(argv[2])
    os.sched_setaffinity(0, cores)
    import torch

    torch.set_num_threads(PROBE_THREADS)
    out = probe_ms(np.random.default_rng(seed), pin)
    print(json.dumps(dict(out, threads=torch.get_num_threads(),
                          cores=sorted(os.sched_getaffinity(0)))))


if __name__ == "__main__":
    _main(sys.argv[1:])
