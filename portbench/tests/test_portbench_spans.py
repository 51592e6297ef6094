"""The program-span readers (portbench/spans.py and the metrics that use
it) on hand-made records and ticks: ms per tile, the window's filter,
None for device metrics on the CPU and for a program without the tracer;
loading a reader switches the tracer on; a traced CPU run reports the
host metrics and leaves out the device ones.

    python -m pytest -q portbench/tests/test_portbench_spans.py
"""

from __future__ import annotations

import os

import pytest

from portbench import harness, registry, spans

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NEW = {"rgb8-ftl-ingest": ("phase_a_ms_per_tile.encode", "fetch_wait_ms_per_tile.encode",
                           "upload_ms_per_tile.encode"),
       "landsat-cfh-ingest": ("phase_a_ms_per_tile.best", "copy_ms_per_tile.best")}
SMALL = {"config": {"width": 32, "height": 32, "crop": 32},
         "traffic": {"pool": 6, "batch": 3}, "warmup_batches": 1, "check_streams": 2}


class FakeRun:
    def __init__(self, *tick_s):
        self.ticks = {"window": [(t, 3, 0, 0) for t in tick_s], "slice": []}


def rec(name, end_s, tiles, host_ms, device_ms=None):
    return dict(name=name, t1_ns=int(end_s * 1e9), tiles=tiles, host_ms=host_ms,
                device_ms=device_ms)


@pytest.fixture(autouse=True)
def at_root(monkeypatch):
    monkeypatch.chdir(ROOT)


@pytest.fixture
def tracer_restored():
    from qb3_tpu_torch import profiling

    yield profiling
    profiling.disable()


def test_ms_per_tile_sums_durations_over_tiles():
    run = FakeRun(10.0, 11.0, 12.0)
    rs = [rec("encode.phase_a", 10.5, 128, 1.0, 30.0),
          rec("encode.phase_a", 11.5, 64, 2.0, 20.0),
          rec("pipeline.upload", 11.0, 128, 9.0)]
    assert spans.ms_per_tile(run, "encode.phase_a", "device_ms", rs) == pytest.approx(50 / 192)
    assert spans.ms_per_tile(run, "encode.phase_a", "host_ms", rs) == pytest.approx(3 / 192)
    assert spans.ms_per_tile(run, "pipeline.upload", "host_ms", rs) == pytest.approx(9 / 128)


def test_window_keeps_records_between_its_first_and_last_tick():
    run = FakeRun(10.0, 11.0, 12.0)
    rs = [rec("s", 9.999, 1, 100.0), rec("s", 10.0, 2, 1.0), rec("s", 12.0, 2, 3.0),
          rec("s", 12.001, 1, 100.0)]
    assert [r["t1_ns"] for r in spans.in_window(rs, run)] == [10_000_000_000, 12_000_000_000]
    assert spans.ms_per_tile(run, "s", "host_ms", rs) == pytest.approx(1.0)
    assert spans.in_window(rs, FakeRun()) == []


def test_none_without_device_times_or_spans():
    run = FakeRun(10.0, 12.0)
    rs = [rec("encode.phase_a", 11.0, 3, 1.0, None), rec("encode.phase_a", 11.5, 3, 1.0, 2.0)]
    assert spans.ms_per_tile(run, "encode.phase_a", "device_ms", rs) is None
    assert spans.ms_per_tile(run, "encode.phase_a", "host_ms", rs) == pytest.approx(2 / 6)
    assert spans.ms_per_tile(run, "batch.fetch", "host_ms", rs) is None
    assert spans.ms_per_tile(run, "s", "host_ms", [rec("s", 11.0, 0, 1.0)]) is None


def _reader(name):
    return registry.load_module(os.path.join(ROOT, "portbench", "metrics", f"{name}.py"),
                                "test_reader_" + name.replace(".", "_"))


def test_copy_reader_adds_the_uploads_and_the_fetch(monkeypatch, tracer_restored):
    run = FakeRun(10.0, 12.0)
    rs = [rec("batch.upload", 10.2, 8, 5.0, 4.0), rec("batch.upload", 10.4, 8, 5.0, 4.0),
          rec("batch.upload", 10.6, 8, 5.0, 4.0), rec("batch.fetch", 10.8, 24, 9.0, 6.0)]
    monkeypatch.setattr(spans, "program_records", lambda: rs)
    assert _reader("copy_ms_per_tile.best").read(run) == pytest.approx(12 / 24 + 6 / 24)
    monkeypatch.setattr(spans, "program_records", lambda: rs[:3])
    assert _reader("copy_ms_per_tile.best").read(run) is None


@pytest.mark.parametrize("name", [n for names in NEW.values() for n in names])
def test_loading_a_reader_switches_the_tracer_on(name, tracer_restored):
    tracer_restored.disable()
    assert tracer_restored.span("a") is tracer_restored.span("b")
    reader = _reader(name)
    assert tracer_restored.span("a") is not tracer_restored.span("b")
    assert reader.read(FakeRun()) is None


def test_program_without_the_tracer_reads_none(monkeypatch, tracer_restored):
    """A parent commit's profiling has no enable() and no records()."""
    monkeypatch.delattr(tracer_restored, "enable")
    monkeypatch.delattr(tracer_restored, "records")
    spans.switch_on()
    assert spans.program_records() == []
    run = FakeRun(10.0, 12.0)
    for names in NEW.values():
        for name in names:
            assert _reader(name).read(run) is None


@pytest.mark.parametrize("name", list(NEW))
def test_traced_cpu_run_reports_the_host_metrics(name, tracer_restored):
    out = harness.execute(name, 2**33 + 5, 0.3, True, device="cpu", overrides=SMALL)
    assert out["correct"] is True
    host = {"fetch_wait_ms_per_tile.encode", "upload_ms_per_tile.encode"}
    assert {n for n in NEW[name] if n in out["metrics"]} == host & set(NEW[name])
    for n in host & set(NEW[name]):
        assert out["metrics"][n]["unit"] == "ms" and out["metrics"][n]["value"] >= 0
