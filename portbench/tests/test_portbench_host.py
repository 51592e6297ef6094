"""The host's facts (portbench/host.py) with the /sys and /proc readers
pointed at fixture trees; the device.host keys of a result line; the host
yardstick, run in a process of its own, and its reader on a recorded Run.

    python -m pytest -q portbench/tests/test_portbench_host.py
"""

from __future__ import annotations

import os

import numpy as np
import pytest

from portbench import harness, host, registry

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BUS = "0000:17:00.0"
SMALL = {"config": {"width": 32, "height": 32, "crop": 32},
         "traffic": {"pool": 6, "batch": 3}, "warmup_batches": 1, "check_streams": 2}
PROBES = {"rgb8-ftl-ingest": "host_probe_ms.encode", "landsat-cfh-ingest": "host_probe_ms.best"}
HOST_KEYS = {"affinity", "cpu_count", "threads", "interop_threads", "cpu_quota", "card_bus_id",
             "card_node", "core_nodes", "window_s", "nr_throttled", "throttled_usec",
             "psi_cpu_some_us", "psi_memory_some_us", "mhz_before", "mhz_after",
             "raw_MBps_by_sixth"}


def tree(base, files: dict) -> str:
    for path, text in files.items():
        p = base / path.lstrip("/")
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(text)
    return str(base)


def v2(base, leaf_max="max 100000", parent_max="250000 100000"):
    return tree(base, {"/proc/self/cgroup": "0::/job/w1\n",
                       "/sys/fs/cgroup/cgroup.controllers": "cpu memory\n",
                       "/sys/fs/cgroup/job/cpu.max": parent_max + "\n",
                       "/sys/fs/cgroup/job/w1/cpu.max": leaf_max + "\n",
                       "/sys/fs/cgroup/job/w1/cpu.stat":
                       "usage_usec 10\nnr_periods 9\nnr_throttled 4\nthrottled_usec 1500\n"})


def numa(base, card_node="1"):
    return tree(base, {f"/sys/bus/pci/devices/{BUS}/numa_node": card_node + "\n",
                       "/sys/devices/system/node/node0/cpulist": "0-3\n",
                       "/sys/devices/system/node/node1/cpulist": "4-7\n"})


def test_cpulist():
    assert host.cpulist("0-3,8,10-11\n") == [0, 1, 2, 3, 8, 10, 11]
    assert host.cpulist("5") == [5]


def test_quota_read_v2(tmp_path):
    """The tightest cpu.max along the cgroup's path, and its throttling."""
    root = v2(tmp_path)
    assert host.cpu_quota(root) == {"cores": 2.5, "at": "/sys/fs/cgroup/job/cpu.max"}
    assert host.throttling(root) == {"nr_throttled": 4, "throttled_usec": 1500}


def test_quota_v1_hierarchy_reads_none(tmp_path):
    """Only cgroup v2's cpu.max is read: a v1 hierarchy's quota is not."""
    root = tree(tmp_path, {"/proc/self/cgroup": "4:memory:/m\n2:cpu,cpuacct:/job\n",
                           "/sys/fs/cgroup/cpu,cpuacct/job/cpu.cfs_quota_us": "300000\n",
                           "/sys/fs/cgroup/cpu,cpuacct/job/cpu.cfs_period_us": "100000\n",
                           "/sys/fs/cgroup/cpu,cpuacct/job/cpu.stat":
                           "nr_periods 3\nnr_throttled 2\nthrottled_time 7000\n"})
    assert host.cpu_quota(root) is None and host.throttling(root) is None


@pytest.mark.parametrize("leaf, parent, cores", [
    ("max 100000", "max 100000", None),   # no quota anywhere
    ("800000 100000", "max 100000", 8.0),
    ("50000 100000", "300000 100000", 0.5),  # the tightest wins, leaf or not
    ("max 100000", "300000 100000", 3.0),
])
def test_quota_tightest_along_the_path(tmp_path, leaf, parent, cores):
    q = host.cpu_quota(v2(tmp_path, leaf_max=leaf, parent_max=parent))
    assert (q and q["cores"]) == cores


def test_card_node_and_cores(tmp_path):
    root = numa(tmp_path)
    assert host.card_node(BUS, root) == 1
    assert host.node_cpus(root) == {0: [0, 1, 2, 3], 1: [4, 5, 6, 7]}
    assert host.card_node(BUS, numa(tmp_path / "unknown", card_node="-1")) is None
    assert host.card_node(None, root) is None


def test_absent_files_read_none(tmp_path):
    root = str(tmp_path)
    assert host.cpu_quota(root) is None and host.throttling(root) is None
    assert host.pressure(root, "cpu") is None and host.cpu_mhz([0], root) is None
    assert host.node_cpus(root) == {} and host.card_node(BUS, root) is None


def test_window_facts_are_changes(tmp_path, monkeypatch):
    files = {"/proc/pressure/cpu": "some avg10=0.00 avg60=0.00 avg300=0.00 total=1000\n"
                                   "full avg10=0.00 avg60=0.00 avg300=0.00 total=0\n",
             "/proc/pressure/memory": "some avg10=0.00 avg60=0.00 avg300=0.00 total=50\n"
                                      "full avg10=0.00 avg60=0.00 avg300=0.00 total=5\n",
             "/proc/cpuinfo": "processor\t: 0\ncpu MHz\t\t: 2000.0\n\n"
                              "processor\t: 1\ncpu MHz\t\t: 3000.0\n"}
    root = v2(tmp_path)
    tree(tmp_path, files)
    monkeypatch.setattr(host, "_affinity", lambda: [0, 1])
    a = host.counters(root)
    assert a["mhz"] == 2500.0
    tree(tmp_path, {"/proc/pressure/cpu": files["/proc/pressure/cpu"].replace("1000", "4000"),
                    "/sys/fs/cgroup/job/w1/cpu.stat": "nr_throttled 10\nthrottled_usec 9500\n"})
    f = host.window_facts(a, host.counters(root))
    assert f["psi_cpu_some_us"] == 3000 and f["psi_memory_some_us"] == 0
    assert f["nr_throttled"] == 6 and f["throttled_usec"] == 8000
    assert f["mhz_before"] == f["mhz_after"] == 2500.0
    assert f["window_s"] >= 0


def test_rate_by_part():
    ticks = [(10.5, 1, 2e6, 0), (11.0, 1, 2e6, 0), (12.9, 1, 4e6, 0)]
    assert host.rate_by_part(ticks, 10.0, 13.0, 3) == pytest.approx([4.0, 0.0, 4.0])


def test_probe_times_its_parts():
    p = host.probe_ms(np.random.default_rng(1), pin=False, repeats=2)
    assert set(p) == {"ms", "copy_ms", "join_ms"}
    assert p["ms"] >= p["copy_ms"] > 0 and p["join_ms"] > 0


def test_probe_runs_apart_from_the_program(monkeypatch):
    """The yardstick's process takes its threads, cores and environment
    from the benchmark's start, not from what the program set since."""
    import torch

    threads = torch.get_num_threads()
    monkeypatch.setitem(os.environ, "OMP_NUM_THREADS", "1")
    try:
        torch.set_num_threads(1)
        p = host.probe(5, pin=False)
    finally:
        torch.set_num_threads(threads)
    assert p["threads"] == host.PROBE_THREADS and p["cores"] == host.CORES
    assert p["ms"] >= p["copy_ms"] > 0 and p["join_ms"] > 0


def _reader(name):
    return registry.load_module(os.path.join(ROOT, "portbench", "metrics", f"{name}.py"),
                                "test_host_reader_" + name.replace(".", "_"))


@pytest.mark.parametrize("name", sorted(PROBES.values()))
def test_probe_reader_on_a_recorded_run(name):
    run = harness.Run(1, "cpu", True)
    assert _reader(name).read(run) is None
    run.host = {"probe": {"ms": 41.25, "copy_ms": 11.0, "join_ms": 30.0}}
    assert _reader(name).read(run) == 41.25


@pytest.mark.parametrize("name", sorted(PROBES))
def test_result_line_carries_the_host(name, monkeypatch):
    monkeypatch.chdir(ROOT)
    out = harness.execute(name, 2**33 + 23, 0.3, True, device="cpu", overrides=SMALL)
    assert out["correct"] is True
    h = out["device"]["host"]
    assert set(h) >= HOST_KEYS
    assert h["affinity"] == sorted(os.sched_getaffinity(0)) and h["card_bus_id"] is None
    assert h["probe"]["ms"] > 0 and h["probe"]["threads"] == host.PROBE_THREADS
    assert h["window_s"] > 0 and len(h["raw_MBps_by_sixth"]) == 6
    assert out["metrics"][PROBES[name]] == {"value": h["probe"]["ms"], "unit": "ms"}
    other = (set(PROBES.values()) - {PROBES[name]}).pop()
    assert other not in out["metrics"]


def test_untraced_line_carries_the_host_without_the_probe(monkeypatch):
    """The yardstick is timed only where its metric is read."""
    monkeypatch.chdir(ROOT)
    out = harness.execute("rgb8-ftl-ingest", 2**33 + 29, 0.3, False, device="cpu",
                          overrides=SMALL)
    h = out["device"]["host"]
    assert out["correct"] is True and set(h) == HOST_KEYS
