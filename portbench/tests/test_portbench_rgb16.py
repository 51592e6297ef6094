"""The 16-bit RGB photo ingest (rgb16-photo-ingest, rgb16-photo-ftl) on the
CPU at a cut size: the image maker, the cell's files and entries, the scene
driver's runs, controls and faults, and its readers.

    python -m pytest -q portbench/tests/test_portbench_rgb16.py
"""

from __future__ import annotations

import os

import numpy as np
import pytest

from portbench import faults, harness, loops, registry, spans
from portbench.rasters import photo16
from portbench.reference import qb3ref

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CELL = "rgb16-photo-ingest"
READERS = ("phase_a_ms_per_scene.rgb16", "pack_ms_per_scene.rgb16",
           "bytes_ms_per_scene.rgb16", "roofline.rgb16", "push_ms_per_scene.rgb16",
           "stitch_ms_per_scene.rgb16", "device_idle.rgb16")
# the readers of a host span: they read on the CPU too
HOST_READERS = {"bytes_ms_per_scene.rgb16", "push_ms_per_scene.rgb16"}
# a test's size: 64 x 64 images pushed 16 rows at a time into 16-row strips, a pool of 2
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


def _images(seed, n=2, h=256, w=384):
    return photo16.make({"height": h, "width": w}, n, np.random.default_rng(seed))


def test_images_are_seeded_uint16_photos_over_most_of_the_range():
    a, b, c = _images(5), _images(5), _images(6)
    assert a.dtype == np.uint16 and a.shape == (2, 256, 384, 3)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    for img in (*a, *c):
        assert 300 < img.min() and img.max() < 65000 and np.ptp(img) > 50000
        # the channels move together: green against red and blue
        g = img[..., 1].astype(np.float64).ravel()
        for ch in (0, 2):
            assert np.corrcoef(g, img[..., ch].astype(np.float64).ravel())[0, 1] > 0.8


def test_images_take_the_configurations_shape():
    """make() reads the height and width from the configuration it is given
    (the cell's own at 7216 x 5412; a cut of it here)."""
    conf = dict(registry.cell(CELL)["config"], height=36, width=52)
    out = photo16.make(conf, 3, np.random.default_rng(2**33 + 1))
    assert out.shape == (3, 36, 52, 3) and out.dtype == np.uint16
    assert all(not np.array_equal(out[0], x) for x in out[1:])


@pytest.mark.parametrize("seed", [0, 1, 2**33 + 3])
def test_ftl_ratio_at_a_cut_size_is_the_sets(seed):
    """The FTL stream (the default core band, no sidecar) is 0.60-0.80 of the
    raw bytes, so the strip encoder, which has no stored fallback, always
    writes the reference's stream; and the core band earns its keep."""
    (img,) = _images(seed, n=1)
    ratio = len(qb3ref.encode(img, qb3ref.FTL)) / img.nbytes
    assert 0.60 <= ratio <= 0.80
    assert len(qb3ref.encode(img, qb3ref.FTL, cband=[0, 1, 2])) / img.nbytes > ratio + 0.02


def test_cell_configuration_mix_and_readers_load():
    cell = registry.cell(CELL)
    conf, tr = cell["config"], cell["traffic"]
    assert registry.driver(cell["driver"]).SHAPE == "stream_scene"
    assert {k: conf[k] for k in ("width", "height", "bands", "dtype", "mode", "quanta", "curve",
                                 "coreband", "index", "strip_rows", "raster", "reduced")} == {
        "width": 7216, "height": 5412, "bands": 3, "dtype": "uint16", "mode": "FTL",
        "quanta": 1, "curve": "hilbert", "coreband": None, "index": None, "strip_rows": 512,
        "raster": "photo16", "reduced": []}
    assert conf["width"] % 4 == conf["height"] % 4 == 0  # each strip takes K8's route
    entry = next(c for c in registry.benchmark()["configs"] if c["name"] == conf["name"])
    assert entry["source"] == conf["source"] and entry["reduced"] == []
    assert len(entry["source"]) <= 200 and len(entry["why"]) <= 200
    assert tr == {"loop": "closed", "pool": 4, "batch": 1, "push_rows": 512}
    assert cell["check_streams"] == 1 and cell["warmup_scenes"] == 1
    assert [m.name for m in registry.end_to_end(CELL)] == ["encode_MBps", "setup_s"]
    layer = registry.per_layer(CELL)
    assert tuple(m.name for m in layer) == READERS
    assert all(callable(m.module.read) for m in layer)


def test_photo_runs_are_correct_and_traced_cpu_runs_read_the_host_span(tracer_restored):
    out = harness.execute(CELL, 2**33 + 29, 0.5, False, device="cpu", overrides=SMALL)
    assert out["correct"] is True and out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"encode_MBps", "setup_s"}
    out = harness.execute(CELL, 2**33 + 29, 0.5, True, device="cpu", overrides=SMALL)
    assert out["correct"] is True
    # no device times and no profile on the CPU: the phase A's, the pack's,
    # the stitch's, the roofline's and the idle share's readers give nothing
    assert set(out["metrics"]) == HOST_READERS
    assert all(out["metrics"][name]["value"] > 0 for name in HOST_READERS)


@pytest.mark.parametrize("kind", faults.kinds("stream_scene"))
def test_photo_faults_read_not_correct(kind):
    """control (each value's lowest bit dropped), reference_control (the
    reference's stream of the images so dropped) and altered (each
    stream's last byte)."""
    out = harness.execute(CELL, 2**33 + 31, 0.3, False, device="cpu", overrides=SMALL,
                          faults=faults.install(kind))
    assert out["correct"] is False
    assert out["checks"]["streams_differ"]["value"] >= 1


def test_the_reference_in_the_programs_place_reads_correct():
    """The check passes the plain reference's own streams: a StripEncoder
    whose finish() returns qb3ref's stream of the rows pushed."""
    from qb3_tpu_torch import strip

    conf = registry.cell(CELL, overrides=SMALL)["config"]

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


@pytest.mark.parametrize("h", [64, 100])
def test_driver_streams_equal_the_references_and_decode_exactly(h):
    """encode_scene.encode of an image, pushed in 16-row pieces (a short last
    one at 100 rows), is qb3ref's FTL stream, and decodes in the reference
    to the image."""
    from portbench.drivers import encode_scene
    from qb3_tpu_torch.api import DT_FROM_NP

    conf = registry.cell(CELL, overrides=SMALL)["config"]
    (img,) = _images(9, n=1, h=h, w=96)
    st = dict(conf=conf, push=16, dtype=DT_FROM_NP[img.dtype])
    stream = encode_scene.encode(st, img, "cpu")
    assert stream == qb3ref.encode(img, qb3ref.FTL)
    assert qb3ref.parse_header(stream)["mode"] == qb3ref.FTL
    assert np.array_equal(qb3ref.decode(stream), img)


class FakeRun:
    def __init__(self, *tick_s):
        self.ticks = {"window": [(t, 1, 234_000_000, 165_000_000) for t in tick_s],
                      "slice": []}
        self.profile = None


def rec(name, end_s, host_ms, device_ms=None):
    return dict(name=name, t1_ns=int(end_s * 1e9), tiles=1, host_ms=host_ms,
                device_ms=device_ms)


def _reader(name):
    return registry.load_module(os.path.join(ROOT, "portbench", "metrics", f"{name}.py"),
                                "test_rgb16_reader_" + name.replace(".", "_"))


def test_span_readers_sum_their_spans_over_the_scenes_after_the_first(monkeypatch,
                                                                     tracer_restored):
    """Two scenes after the first, each with two strips' pushes on the host,
    their phase A and pack on the card, one stitch on the card and one
    strip.bytes on the host."""
    run = FakeRun(10.0, 11.0, 12.0)
    rs = [rec("encode.phase_a", 9.5, 1.0, 100.0), rec("strip.push", 9.5, 300.0)]
    for end in (10.2, 10.4, 11.2, 11.4):
        rs += [rec("encode.phase_a", end, 1.0, 10.0), rec("encode.pack", end + 0.05, 0.1, 0.5),
               rec("strip.push", end + 0.06, 70.0)]
    rs += [rec("strip.stitch", 10.8, 0.5, 2.0), rec("strip.stitch", 11.8, 0.5, 4.0)]
    rs += [rec("strip.bytes", 10.9, 30.0), rec("strip.bytes", 11.9, 50.0)]
    monkeypatch.setattr(spans, "program_records", lambda: rs)
    assert _reader("phase_a_ms_per_scene.rgb16").read(run) == pytest.approx(20.0)
    assert _reader("pack_ms_per_scene.rgb16").read(run) == pytest.approx(1.0)
    assert _reader("bytes_ms_per_scene.rgb16").read(run) == pytest.approx(40.0)
    assert _reader("push_ms_per_scene.rgb16").read(run) == pytest.approx(140.0)
    assert _reader("stitch_ms_per_scene.rgb16").read(run) == pytest.approx(3.0)
    traced = harness.Run(1, "cpu", True)
    traced.ticks["slice"] = [(12.5, 1, 234_000_000, 165_000_000)]
    assert _reader("roofline.rgb16").read(traced) is None  # no profile
    assert _reader("device_idle.rgb16").read(traced) is None
    traced.profile = {"active_s": 0.2, "wall_s": 2.0}
    assert _reader("roofline.rgb16").read(traced) == pytest.approx(
        100 * 399e6 / 3.35e12 / 0.2)
    assert _reader("device_idle.rgb16").read(traced) == pytest.approx(0.9)


@pytest.mark.parametrize("name", READERS)
def test_readers_give_none_without_the_spans(name, monkeypatch, tracer_restored):
    """A run whose program recorded none of the spans (or, for the device
    spans, no device time: the CPU), and a parent commit's program, whose
    profiling has no enable() and no records()."""
    run = FakeRun(10.0, 11.0, 12.0)
    real = spans.program_records
    monkeypatch.setattr(spans, "program_records", lambda: [rec("strip.finish", 11.0, 1.0)])
    assert _reader(name).read(run) is None
    monkeypatch.setattr(spans, "program_records",
                        lambda: [rec("encode.phase_a", 10.5, 1.0), rec("encode.pack", 10.6, 1.0)])
    assert _reader(name).read(run) is None
    monkeypatch.setattr(spans, "program_records", real)
    monkeypatch.delattr(tracer_restored, "enable")
    monkeypatch.delattr(tracer_restored, "records")
    assert _reader(name).read(run) is None
