"""The DEM strip ingest (dem-strip-ingest, srtm90-i16-cfrle-q4) on the CPU
at a cut size: the scene maker, the cell's files and entries, the scene
driver's runs, controls and faults, and its span readers.

    python -m pytest -q portbench/tests/test_portbench_dem.py
"""

from __future__ import annotations

import os

import numpy as np
import pytest

from portbench import faults, harness, loops, per_scene, registry, spans
from portbench.rasters import srtm
from portbench.reference import qb3ref

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CELL = "dem-strip-ingest"
READERS = ("push_ms_per_scene.dem", "quantize_ms_per_scene.dem", "stitch_ms_per_scene.dem",
           "rle0_ms_per_scene.dem", "roofline.dem")
# a test's size: 64 x 64 scenes pushed 16 rows at a time into 16-row strips, a pool of 2
SMALL = {"config": {"width": 64, "height": 64, "strip_rows": 16},
         "traffic": {"pool": 2, "push_rows": 16}}


@pytest.fixture(autouse=True)
def at_root(monkeypatch):
    monkeypatch.chdir(ROOT)


@pytest.fixture
def tracer_restored():
    from qb3_tpu_torch import profiling

    yield profiling
    profiling.disable()


def _scenes(seed, n=3, h=256, w=192):
    return srtm.make({"height": h, "width": w}, n, np.random.default_rng(seed))


def test_scenes_are_seeded_int16_terrain_with_a_quarter_sea():
    a, b, c = _scenes(5), _scenes(5), _scenes(6)
    assert a.dtype == np.int16 and a.shape == (3, 256, 192, 1)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    for scenes in (a, c):
        for i, s in enumerate(scenes):
            assert all(not np.array_equal(s, t) for t in scenes[i + 1:])
            sea = s == srtm.SEA
            assert 0.12 < sea.mean() < 0.38
            land = s[~sea]
            assert land.min() >= 0 and 1000 < land.max() <= 4700


def test_cell_configuration_mix_and_readers_load():
    cell = registry.cell(CELL)
    conf, tr = cell["config"], cell["traffic"]
    assert registry.driver(cell["driver"]).SHAPE == "stream_scene"
    assert {k: conf[k] for k in ("width", "height", "bands", "dtype", "mode", "quanta", "away",
                                 "curve", "coreband", "index", "strip_rows", "raster")} == {
        "width": 6000, "height": 6000, "bands": 1, "dtype": "int16", "mode": "CF_RLE_H",
        "quanta": 4, "away": False, "curve": "hilbert", "coreband": None, "index": None,
        "strip_rows": 512, "raster": "srtm"}
    entry = next(c for c in registry.benchmark()["configs"] if c["name"] == conf["name"])
    assert entry["source"] == conf["source"] and entry["reduced"] == []
    assert tr == {"loop": "closed", "pool": 4, "batch": 1, "push_rows": 512}
    assert cell["check_streams"] == 1 and cell["warmup_scenes"] == 1
    assert [m.name for m in registry.end_to_end(CELL)] == ["encode_MBps", "setup_s"]
    layer = registry.per_layer(CELL)
    assert tuple(m.name for m in layer) == READERS
    assert all(callable(m.module.read) for m in layer)


def test_scene_runs_are_correct_and_traced_cpu_runs_read_the_host_spans(tracer_restored):
    out = harness.execute(CELL, 2**33 + 29, 0.5, False, device="cpu", overrides=SMALL)
    assert out["correct"] is True and out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"encode_MBps", "setup_s"}
    out = harness.execute(CELL, 2**33 + 29, 0.5, True, device="cpu", overrides=SMALL)
    assert out["correct"] is True
    # no device times and no profile on the CPU: the stitch's and the roofline's
    # readers give nothing
    assert set(out["metrics"]) == {"push_ms_per_scene.dem", "quantize_ms_per_scene.dem",
                                   "rle0_ms_per_scene.dem"}
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert 0 < m["quantize_ms_per_scene.dem"] < m["push_ms_per_scene.dem"]


@pytest.mark.parametrize("kind", faults.kinds("stream_scene"))
def test_scene_faults_read_not_correct(kind):
    """control (the step's lowest bit dropped), reference_control (the
    reference's stream of the rasters so dropped) and altered (each
    stream's last byte)."""
    out = harness.execute(CELL, 2**33 + 31, 0.3, False, device="cpu", overrides=SMALL,
                          faults=faults.install(kind))
    assert out["correct"] is False
    assert out["checks"]["streams_differ"]["value"] >= 1


def test_the_reference_in_the_programs_place_reads_correct():
    """The check passes the plain reference's own streams: a StripEncoder
    whose finish() returns qb3ref's stream of the rows pushed."""
    from qb3_tpu_torch import strip

    cell = registry.cell(CELL, overrides=SMALL)
    conf = cell["config"]

    class Reference(strip.StripEncoder):
        def __init__(self, width, height, bands, *a, **kw):
            super().__init__(width, height, bands, *a, **kw)
            self._rows = []

        def push(self, rows):
            self._rows.append(np.asarray(rows).copy())

        def finish(self):
            return loops.reference_stream(conf, np.concatenate(self._rows))

    def hook(cell, driver):
        saved = [(strip, "StripEncoder", strip.StripEncoder)]
        strip.StripEncoder = Reference
        return saved

    out = harness.execute(CELL, 2**33 + 37, 0.3, False, device="cpu", overrides=SMALL,
                          faults=hook)
    assert out["correct"] is True and strip.StripEncoder is not Reference


def test_driver_streams_equal_the_references():
    """encode_scene.encode of a pool scene is qb3ref's CF_RLE_H stream at the
    step 4, and decodes in the reference to the dequantized scene, the sea
    exact."""
    from portbench.drivers import encode_scene
    from qb3_tpu_torch.api import DT_FROM_NP

    conf = registry.cell(CELL, overrides=SMALL)["config"]
    scene = _scenes(9, n=1, h=64, w=64)[0]
    st = dict(conf=conf, push=16, dtype=DT_FROM_NP[scene.dtype])
    stream = encode_scene.encode(st, scene, "cpu")
    assert stream == qb3ref.encode(scene, qb3ref.CF_RLE_H, quanta=4)
    assert qb3ref.parse_header(stream)["mode"] == qb3ref.CF_RLE_H
    out = qb3ref.decode(stream)
    assert np.array_equal(out, loops.reference_raster(conf, scene))
    assert np.abs(out.astype(np.int64) - scene)[scene != srtm.SEA].max() <= 2
    assert np.all(out[scene == srtm.SEA] == srtm.SEA)


class FakeRun:
    def __init__(self, *tick_s):
        self.ticks = {"window": [(t, 1, 72_000_000, 9_000_000) for t in tick_s], "slice": []}
        self.profile = None


def rec(name, end_s, host_ms, device_ms=None):
    return dict(name=name, t1_ns=int(end_s * 1e9), tiles=0, host_ms=host_ms,
                device_ms=device_ms)


def test_ms_per_scene_sums_the_window_over_its_scenes_after_the_first(monkeypatch):
    """The spans that end between the first and the last completion belong
    to the scenes after the first: here two."""
    run = FakeRun(10.0, 11.0, 12.0)
    rs = [rec("strip.push", 9.5, 100.0), rec("strip.push", 10.5, 3.0),
          rec("strip.push", 11.5, 5.0), rec("strip.stitch", 11.9, 1.0, 0.25),
          rec("strip.stitch", 10.9, 1.0, 0.5), rec("strip.push", 12.5, 100.0)]
    monkeypatch.setattr(spans, "program_records", lambda: rs)
    assert per_scene.ms_per_scene(run, "strip.push", "host_ms") == pytest.approx(4.0)
    assert per_scene.ms_per_scene(run, "strip.stitch", "device_ms") == pytest.approx(0.375)
    assert per_scene.ms_per_scene(FakeRun(10.0), "strip.push", "host_ms") is None
    assert per_scene.ms_per_scene(run, "finish.rle0", "host_ms") is None
    monkeypatch.setattr(spans, "program_records", lambda: [rec("strip.stitch", 10.5, 1.0)])
    assert per_scene.ms_per_scene(run, "strip.stitch", "device_ms") is None


def _reader(name):
    return registry.load_module(os.path.join(ROOT, "portbench", "metrics", f"{name}.py"),
                                "test_dem_reader_" + name.replace(".", "_"))


@pytest.mark.parametrize("name", READERS)
def test_readers_give_none_without_the_spans(name, monkeypatch, tracer_restored):
    """A run whose program recorded none of the spans, and a parent commit's
    program, whose profiling has no enable() and no records()."""
    run = FakeRun(10.0, 11.0, 12.0)
    real = spans.program_records
    monkeypatch.setattr(spans, "program_records", lambda: [rec("encode.phase_a", 11.0, 1.0)])
    assert _reader(name).read(run) is None
    monkeypatch.setattr(spans, "program_records", real)
    monkeypatch.delattr(tracer_restored, "enable")
    monkeypatch.delattr(tracer_restored, "records")
    assert _reader(name).read(run) is None
