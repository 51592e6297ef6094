"""The benchmark's harness on the CPU: files found by name, no JAX, no CPU
fallback, the result line's keys, and the check's controls and faults.

Runs here drive the program's CPU path (its kernels' plain twins) at a
test's size through harness.execute, which skips the look for a card; the
command line (run.py) refuses to run without one.

    python -m pytest -q portbench/tests/test_portbench_harness.py
"""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from portbench import faults, harness, loops, registry
from portbench.rasters import headline

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PKG = os.path.join(ROOT, "portbench")
BENCH = registry.benchmark(ROOT)
# cells held out of BENCHMARK.json (portbench/held/): their entries, which
# the tests merge into a copy, as a later change would into the file
HELD = {f[:-5]: json.load(open(os.path.join(PKG, "held", f)))
        for f in sorted(os.listdir(os.path.join(PKG, "held")))}
WORKLOADS = [w["name"] for w in BENCH["workloads"]] + list(HELD)
# a test's size: 32 x 32 tiles, pools of 6, batches of 3
SMALL = {"config": {"width": 32, "height": 32, "crop": 32},
         "traffic": {"pool": 6, "batch": 3}, "warmup_batches": 1, "warmup_requests": 2,
         "rate_per_s": 20, "check_streams": 2, "check_share": 1.0}
CONTRACT_KEYS = {"correct", "attempted", "failed", "metrics", "device"}


@pytest.fixture(autouse=True)
def at_root(monkeypatch):
    monkeypatch.chdir(ROOT)


@pytest.fixture(scope="module")
def broot(tmp_path_factory) -> str:
    """A root whose BENCHMARK.json also holds the held-out cells."""
    root = tmp_path_factory.mktemp("bench")
    bench = json.loads(json.dumps(BENCH))
    for entries in HELD.values():
        for key, items in entries.items():
            bench[key] += items
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    shutil.copytree(os.path.join(PKG, "configs"), root / "portbench" / "configs")
    return str(root)


@pytest.mark.parametrize("name", WORKLOADS)
def test_cell_files_found_by_name(name, broot):
    cell = registry.cell(name, broot)
    driver = registry.driver(cell["driver"])
    for fn in ("setup", "window", "verify"):
        assert callable(getattr(driver, fn))
    assert ":" in driver.ENTRY and driver.SHAPE
    assert cell["config"]["name"] == registry.workload(name, broot)["config"]
    assert cell["traffic"]["loop"] in ("closed", "open")
    names = {m.name for m in registry.end_to_end(name, broot)}
    assert "setup_s" in names and len(names) >= 2
    layer = registry.per_layer(name, broot)
    assert layer and all(callable(m.module.read) for m in layer)


def test_every_file_named_in_benchmark_exists():
    for c in BENCH["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
    for m in BENCH["per_layer"] + [m for h in HELD.values() for m in h["per_layer"]]:
        assert os.path.exists(os.path.join(PKG, "metrics", f"{m['name']}.py"))
    for w in BENCH["workloads"] + [w for h in HELD.values() for w in h["workloads"]]:
        assert os.path.exists(os.path.join(PKG, "traffic", f"{w['traffic']}.json"))
        assert os.path.exists(os.path.join(PKG, "cells", f"{w['name']}.json"))


def test_cell_added_as_files_alone(tmp_path):
    """A copy of the benchmark gains a cell, a mix and a metric by new files
    and new entries only, and a fresh process finds all three."""
    shutil.copytree(PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "cache"))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "rgb8-ftl-ingest-small", "config": "cid22-rgb8-ftl",
                               "traffic": "closed-32-of-64", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "tiles_done.encode", "unit": "tiles",
                               "better": "higher", "source": "host_clock", "layer": "test",
                               "moves": "encode_MBps", "workloads": ["rgb8-ftl-ingest-small"]})
    for m in bench["end_to_end"]:
        if m["name"] == "encode_MBps":
            m["workloads"].append("rgb8-ftl-ingest-small")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "portbench" / "traffic" / "closed-32-of-64.json").write_text(
        json.dumps({"loop": "closed", "pool": 64, "batch": 32}))
    (tmp_path / "portbench" / "cells" / "rgb8-ftl-ingest-small.json").write_text(
        json.dumps({"driver": "encode_pipelined", "warmup_batches": 1, "check_streams": 1}))
    (tmp_path / "portbench" / "metrics" / "tiles_done.encode.py").write_text(
        "def read(run):\n    return run.totals('window')[0]\n")
    code = ("from portbench import registry; c = registry.cell('rgb8-ftl-ingest-small'); "
            "print(c['driver'], c['traffic']['batch'], "
            "[m.name for m in registry.per_layer('rgb8-ftl-ingest-small')], "
            "[m.name for m in registry.end_to_end('rgb8-ftl-ingest-small')])")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["encode_pipelined", "32", "['tiles_done.encode']",
                                  "['encode_MBps',", "'setup_s']"]


def _imports(path: str) -> set[str]:
    tree = ast.parse(open(path).read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module)
    return out


def test_no_jax_imported():
    """No module of the benchmark imports JAX or the JAX package, compared
    by whole top-level names (qb3_tpu_torch begins with qb3_tpu)."""
    seen = set()
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                seen |= {m.split(".")[0] for m in _imports(os.path.join(dirpath, f))}
    assert not seen & set(harness.FORBIDDEN)
    assert "qb3_tpu_torch" in seen


def test_forbidden_modules_by_whole_name(monkeypatch):
    import types

    assert "qb3_tpu_torch" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "qb3_tpu_torch_fake", types.ModuleType("qb3_tpu_torch_fake"))
    assert "qb3_tpu_torch_fake" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", types.ModuleType("jaxlib.fake"))
    assert "jaxlib.fake" in harness.forbidden_modules()


def test_refuses_without_a_card():
    """The command line exits non-zero and prints no result without CUDA."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", WORKLOADS[0],
                          "--seed", "3000000000", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "refused" in out.stderr


def test_refuses_without_the_program(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's files,
    a run fails and prints no result."""
    shutil.copytree(PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "cache"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", WORKLOADS[0],
                          "--seed", "5", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", WORKLOADS)
def test_result_line_keys(name, trace, broot):
    out = harness.execute(name, 2**33 + 17, 0.3, bool(trace), device="cpu", root=broot,
                          overrides=SMALL)
    assert set(out) - {"breakdown", "checks"} == CONTRACT_KEYS
    assert list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    names = {m.name for m in (registry.per_layer(name, broot) if trace
                              else registry.end_to_end(name, broot))}
    assert set(out["metrics"]) <= names
    if not trace:
        assert set(out["metrics"]) == names
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"}
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(out)


@pytest.mark.parametrize("name", WORKLOADS)
def test_control_and_faults_fail(name, broot):
    """The reference in the program's place with one bit dropped, half of a
    batch left out, every answer altered: each run comes out not correct."""
    shape = registry.driver(registry.cell(name, broot)["driver"]).SHAPE
    for kind in faults.kinds(shape):
        out = harness.execute(name, 99, 0.3, False, device="cpu", root=broot,
                              overrides=SMALL, faults=faults.install(kind))
        assert out["correct"] is False, kind


def test_profile_reduction():
    """Device time is the union of the device records, without the
    sentinels and without the device-side copies of the host ranges; each
    idle gap goes to the innermost host range open at its middle."""
    ev = [(True, "spin_kernel", 0, 50),
          (False, "pb:decode", 100, 400), (True, "pb:decode", 110, 390),
          (False, "pb:arrival_wait", 400, 700),
          (True, "k1", 100, 200), (True, "k2", 150, 250), (True, "k1", 600, 650),
          (True, "k3", 800, 900)]
    p = harness.reduce_events(ev, 0.001)
    assert p["active_s"] == pytest.approx(300e-6)
    assert p["per_op"] == pytest.approx({"k1": 150e-6, "k2": 100e-6, "k3": 100e-6})
    assert p["gaps"] == pytest.approx({"arrival_wait": 350e-6, "other": 150e-6})
    assert p["busy_s"] == pytest.approx(300e-6) and p["wall_s"] == 0.001


# a lossy configuration the benchmark has no cell of yet: an int16 scene at
# the step 4 in CF_RLE_H, fed to the port's StripEncoder in rows
SCENE_CONF = {"name": "scene-i16-q4", "dtype": "int16", "bands": 1, "mode": "CF_RLE_H",
              "quanta": 4, "coreband": None, "index": None}


def _scene(h: int = 32, w: int = 32, seed: int = 5) -> np.ndarray:
    """A smooth int16 field with negative values and a sea at the type's
    minimum over its left quarter."""
    from portbench.tests.test_portbench_reference import signed_raster

    return signed_raster("dem", np.int16, h, w, 1, seed)


def test_reference_stream_follows_the_configuration():
    """reference_stream is the reference's encode under the configuration's
    mode, sidecar, core bands, step and rounding."""
    from portbench.reference import qb3ref

    conf = registry.cell("rgb8-ftl-ingest")["config"]
    tile = headline.headline_image(32, 32, 3, 7)
    assert loops.reference_stream(conf, tile) == qb3ref.encode(tile, qb3ref.FTL, index="ic")
    img = _scene()
    for away in (False, True):
        lossy = dict(SCENE_CONF, away=away)
        assert loops.reference_stream(lossy, img) == qb3ref.encode(
            img, qb3ref.CF_RLE_H, quanta=4, away=away)
    assert loops.reference_stream(SCENE_CONF, img) != loops.reference_stream(
        dict(SCENE_CONF, quanta=1), img)


def test_checks_of_a_lossy_configuration():
    """streams_differ and arrays_differ on int16 rasters at the step 4:
    the port's streams and decoded rasters pass, altered ones and the
    raster itself (not multiplied back) do not."""
    import qb3_tpu_torch as q

    pool = np.stack([_scene(seed=s) for s in (1, 2, 3)])
    streams = [q.encode(t, mode=7, quanta=4, device="cpu") for t in pool]
    kept = list(enumerate(streams))
    rng = np.random.default_rng
    assert loops.streams_differ(kept, pool, SCENE_CONF, 3, rng(1)) == 0
    bad = [(i, faults._alter_stream(s)) for i, s in kept]
    assert loops.streams_differ(bad, pool, SCENE_CONF, 3, rng(1)) == 3
    assert loops.streams_differ(kept, pool, dict(SCENE_CONF, away=True), 3, rng(1)) == 3
    decoded = [(i, q.decode(s, device="cpu")[0]) for i, s in kept]
    assert loops.arrays_differ(decoded, pool, SCENE_CONF) == 0
    assert loops.arrays_differ(list(enumerate(pool)), pool, SCENE_CONF) == 3
    assert loops.arrays_differ(list(enumerate(pool)), pool, dict(SCENE_CONF, quanta=1)) == 0


@pytest.mark.parametrize("kind", faults.kinds("stream_scene") + (None,))
def test_stream_scene_faults(kind):
    """Each fault of a streaming entry, around the port's StripEncoder on
    the CPU (32x32x1 int16, step 4, CF_RLE_H, pushed 8 rows at a time),
    gives a stream other than the reference's; the entry unbroken gives
    the reference's.  The wrapped class is built as the class is."""
    import inspect
    import types

    from qb3_tpu_torch import strip
    from qb3_tpu_torch.constants import DType

    assert "half" not in faults.kinds("stream_scene")
    img = _scene()
    entry = types.SimpleNamespace(ENTRY="qb3_tpu_torch.strip:StripEncoder",
                                  SHAPE="stream_scene")
    cls = strip.StripEncoder
    saved = faults.install(kind)({"config": SCENE_CONF}, entry) if kind else []
    try:
        assert inspect.signature(strip.StripEncoder) == inspect.signature(cls)
        enc = strip.StripEncoder(32, 32, 1, DType.I16, mode=7, quanta=4, device="cpu")
        for y in range(0, 32, 8):
            enc.push(img[y: y + 8])
        stream = enc.finish()
    finally:
        harness.restore(saved)
    assert strip.StripEncoder is cls
    assert (stream == loops.reference_stream(SCENE_CONF, img)) == (kind is None)
