"""qb3_tpu_torch.profiling's tracer: off, one shared no-op and no record;
on, spans that nest, share their batch's id and count its tiles, kept in a
bounded ring, per thread; the encode paths' streams the same with it on
and off (batch.encode_tiles in FTL "ic" and CF_H, the pipelined encode);
"qb3:" ranges in profiling.trace()'s Chrome trace and none in a plain
profile; profiler_us against a record_function marker; counters() with
every kernel wrapper's launches, the pipeline's fetch-cap misses and the
batch encode's staged copies, which the CPU never counts; the strip
encoder's spans, nested under each push and its finish (the RLE0 pass only
in an RLE mode; the step's span, around K11's wrapper, only at a step of 2
or more), and its strips and scenes counted.

The card's part (device times, the streams on the card) skips without a
CUDA device.  This file imports neither jax nor qb3_tpu:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_profiling.py
"""

import importlib
import json
import os
import re
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from qb3_tpu_torch import api, batch, container, pipeline, profiling, strip
from qb3_tpu_torch.constants import DType, Mode
from qb3_tpu_torch.ops.quantize_cuda import quantize_carrier

OPS = os.path.join(os.path.dirname(os.path.abspath(profiling.__file__)), "ops")
FINISH = ("finish.sidecar", "finish.headers", "finish.bytes")
STAGED = ("batch.staged_uploads", "batch.staged_fetches")
STRIP = ("strip.strips", "strip.scenes")


@pytest.fixture(autouse=True)
def tracer_off():
    """Each test starts with the tracer off and its ring empty, and leaves
    it off."""
    profiling.disable()
    profiling.enable()
    profiling.disable()
    yield
    profiling.disable()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (device times come from CUDA events)")
    return "cuda"


def _tiles(n, seed, h=32, w=32, c=3):
    """n smooth u8 tiles (small deltas, so every mode codes them)."""
    rng = np.random.default_rng(seed)
    return (np.cumsum(rng.integers(-3, 4, (n, h, w, c)), axis=2) % 256).astype(np.uint8)


def _by_batch(records):
    out = {}
    for r in records:
        out.setdefault(r["batch"], []).append(r)
    return out


def test_off_span_is_one_shared_noop_and_records_nothing():
    a = profiling.span("a", 3)
    assert a is profiling.span("b", device="cpu") is profiling.batch() is profiling.batch(7)
    with a as entered, profiling.batch() as bid:
        pass
    assert entered is None and bid is None
    batch.encode_tiles(_tiles(2, 1), index="ic", device="cpu")
    list(pipeline.encode_tiles_pipelined([_tiles(2, 2)] * 2, index="ic", device="cpu"))
    assert profiling.records() == []


def test_spans_nest_share_their_batch_and_count_tiles():
    profiling.enable()
    with profiling.batch() as bid:
        with profiling.span("outer", 5):
            with profiling.span("inner", 5):
                pass
            with profiling.span("inner2", 5):
                pass
    with profiling.batch() as other:
        pass
    with profiling.batch(bid):
        with profiling.span("late", 5):
            pass
    with profiling.span("loose"):
        pass
    rs = {r["name"]: r for r in profiling.records()}
    assert rs["inner"]["parent"] == rs["inner2"]["parent"] == rs["outer"]["id"]
    assert rs["outer"]["parent"] is None and rs["late"]["parent"] is None
    assert other != bid
    assert {rs[k]["batch"] for k in ("outer", "inner", "inner2", "late")} == {bid}
    assert rs["loose"]["batch"] is None and rs["loose"]["tiles"] == 0
    assert rs["outer"]["tiles"] == rs["inner"]["tiles"] == 5
    assert (rs["outer"]["t0_ns"] <= rs["inner"]["t0_ns"] <= rs["inner"]["t1_ns"]
            <= rs["inner2"]["t0_ns"] <= rs["inner2"]["t1_ns"] <= rs["outer"]["t1_ns"])
    for r in rs.values():
        assert r["host_ms"] == (r["t1_ns"] - r["t0_ns"]) / 1e6 and r["device_ms"] is None


def _ftl_ic(device, seed):
    return batch.encode_tiles(_tiles(3, seed), index="ic", device=device)


def _cf_h(device, seed):
    return batch.encode_tiles(_tiles(2, seed), mode=Mode.CF_H, device=device)


def _pipelined(device, seed):
    tiles = [_tiles(3, seed + k) for k in range(3)]
    return list(pipeline.encode_tiles_pipelined(tiles, index="ic", device=device))


# each path's spans, a batch
PATHS = {"ftl_ic": (_ftl_ic, {"encode.phase_a", "encode.pack", "batch.fetch",
                              "batch.finish", *FINISH}),
         "cf_h": (_cf_h, {"batch.upload", "encode.phase_a", "encode.pack", "batch.fetch",
                          "batch.finish", *FINISH}),
         "pipelined": (_pipelined, {"pipeline.upload", "encode.phase_a", "encode.pack",
                                    "pipeline.fetch_wait", "pipeline.finish", *FINISH})}


@pytest.mark.parametrize("path", list(PATHS))
def test_streams_are_the_same_with_the_tracer_on(path):
    encode, names = PATHS[path]
    off = encode("cpu", 11)
    profiling.enable()
    assert encode("cpu", 11) == off
    groups = _by_batch(profiling.records())
    assert None not in groups and len(groups) == (3 if path == "pipelined" else 1)
    for rs in groups.values():
        assert {r["name"] for r in rs} == names
        assert {r["tiles"] for r in rs} == {3 if path != "cf_h" else 2}
        ids = {r["name"]: r["id"] for r in rs}
        finish = "pipeline.finish" if path == "pipelined" else "batch.finish"
        for r in rs:
            assert r["parent"] == (ids[finish] if r["name"] in FINISH else None)


@pytest.mark.parametrize("path", ["ftl_ic", "cf_h"])
def test_cpu_batch_copies_are_not_staged(path):
    """On the CPU batch.encode_tiles copies plainly: neither staged counter
    moves, and the path keeps its copy spans (batch.upload a best pass,
    batch.fetch a batch)."""
    encode, names = PATHS[path]
    before = profiling.counters()
    profiling.enable()
    encode("cpu", 13)
    after = profiling.counters()
    assert {k: after[k] - before[k] for k in STAGED} == {k: 0 for k in STAGED}
    rs = profiling.records()
    assert {r["name"] for r in rs} == names
    copies = [r["name"] for r in rs if r["name"] in ("batch.upload", "batch.fetch")]
    assert copies == (["batch.upload", "batch.fetch"] if path == "cf_h" else ["batch.fetch"])


@pytest.mark.parametrize("order,misses", [(("smooth", "noisy", "smooth"), 0),
                                          (("smooth", "smooth", "noisy"), 1)],
                         ids=["smooth-noisy-smooth", "smooth-smooth-noisy"])
def test_cap_misses_count_the_batches_past_the_fetch_cap(order, misses):
    """The third batch's fetch cap comes from the first batch's worst tile
    (tests/test_torch_pipeline.py): a noisy third batch passes it."""
    rng = np.random.default_rng(3)
    kinds = {"smooth": np.zeros((2, 64, 64, 1), np.uint8),
             "noisy": (rng.integers(0, 2, (2, 64, 64, 1)) * 120
                       + rng.integers(0, 60, (2, 64, 64, 1))).astype(np.uint8)}
    before = profiling.counters()["pipeline.cap_misses"]
    list(pipeline.encode_tiles_pipelined([kinds[k] for k in order], index="ic", device="cpu"))
    assert profiling.counters()["pipeline.cap_misses"] - before == misses


def _dem_strips(mode, seed=7, h=184, w=32, device="cpu", quanta=4):
    """An int16 scene (smooth land, a sea at the type's minimum over its left
    quarter) at the step 4 through StripEncoder at strip_rows 16, pushed 16
    rows at a time: 11 whole strips, then the flush of the last 8 rows, as a
    6000-row scene pushed in 512-row pieces makes 11 strips and one of 368."""
    rng = np.random.default_rng(seed)
    img = (np.cumsum(rng.integers(-3, 4, (h, w, 1)), axis=1) + 500).astype(np.int16)
    img[:, : w // 4] = np.iinfo(np.int16).min
    se = strip.StripEncoder(w, h, 1, DType.I16, mode=mode, quanta=quanta, strip_rows=16,
                            device=device)
    for y in range(0, h, 16):
        se.push(img[y: y + 16])
    return se.finish()


@pytest.mark.parametrize("mode", [Mode.CF_RLE_H, Mode.CF_H])
def test_strip_spans_nest_under_push_and_finish(mode):
    """Off: no record, and the counters still count.  On: the same stream; a
    strip.push a push, each holding its strip's strip.encode, which holds
    the strip's strip.quantize (K11's launch, its twin here); strip.finish
    holding strip.stitch, strip.bytes and, in the RLE mode alone,
    finish.rle0; 12 strips and one scene counted."""
    before = profiling.counters()
    off = _dem_strips(mode)
    assert profiling.records() == []
    mid = profiling.counters()
    assert {k: mid[k] - before[k] for k in STRIP} == {"strip.strips": 12, "strip.scenes": 1}
    profiling.enable()
    assert _dem_strips(mode) == off
    assert container.parse_headers(off).mode == mode  # the RLE0 pass was taken
    after = profiling.counters()
    assert {k: after[k] - mid[k] for k in STRIP} == {"strip.strips": 12, "strip.scenes": 1}
    by = {}
    for r in profiling.records():
        by.setdefault(r["name"], []).append(r)
    rle = ["finish.rle0"] if mode == Mode.CF_RLE_H else []
    assert {k: len(v) for k, v in by.items()} == {
        "strip.push": 12, "strip.quantize": 12, "strip.encode": 12, "strip.finish": 1,
        "strip.stitch": 1, "strip.bytes": 1, **{k: 1 for k in rle}}
    pushes = [r["id"] for r in by["strip.push"]]
    assert [r["parent"] for r in by["strip.encode"]] == pushes
    assert [r["parent"] for r in by["strip.quantize"]] == [r["id"] for r in by["strip.encode"]]
    (fin,) = by["strip.finish"]
    assert fin["parent"] is None and all(r["parent"] is None for r in by["strip.push"])
    for name in ["strip.stitch", "strip.bytes", *rle]:
        assert by[name][0]["parent"] == fin["id"]
    assert by["strip.bytes"][0]["t0_ns"] >= by["strip.stitch"][0]["t1_ns"]
    for r in (r for rs in by.values() for r in rs):
        assert r["device_ms"] is None and r["host_ms"] >= 0


@pytest.mark.parametrize("quanta", [1, 4])
def test_strips_quantize_through_k11s_wrapper_at_a_step(monkeypatch, quanta):
    """At the step 4 each strip hands its values to K11's wrapper once,
    inside its strip.quantize span, with the raster's type (16 bits,
    signed) and the step; at step 1 neither the wrapper nor the span is
    reached.  The CPU launches no kernel."""
    seen = []

    def k11(*a, **k):
        seen.append(a[1:])
        return quantize_carrier(*a, **k)

    monkeypatch.setattr(api, "quantize_carrier", k11)
    launches = quantize_carrier.launches
    profiling.enable()
    _dem_strips(Mode.CF_RLE_H, quanta=quanta)
    names = [r["name"] for r in profiling.records()]
    assert quantize_carrier.launches == launches
    if quanta == 1:
        assert seen == [] and "strip.quantize" not in names
    else:
        assert seen == [(16, True, 4, False)] * 12 and names.count("strip.quantize") == 12


def test_trace_writes_qb3_ranges(tmp_path):
    with profiling.trace(str(tmp_path)):
        _ftl_ic("cpu", 3)
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert {"qb3:" + n for n in PATHS["ftl_ic"][1]} <= names
    assert profiling.span("x") is profiling.span("y")  # off again after the trace


def test_plain_profile_holds_no_qb3_range():
    profiling.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _ftl_ic("cpu", 4)
    assert not [e.name for e in prof.events() if e.name.startswith("qb3:")]
    assert {r["name"] for r in profiling.records()} == PATHS["ftl_ic"][1]


def test_profiler_us_maps_a_span_onto_the_profile():
    profiling.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm-up"):
            pass
        for i in range(3):
            time.sleep(0.003)
            with record_function(f"marker{i}"), profiling.span(f"s{i}"):
                time.sleep(0.002)
    events = {e.name: e for e in prof.events()}
    for r in profiling.records():
        m = events["marker" + r["name"][1:]]
        assert abs(profiling.profiler_us(r["t0_ns"], prof) - m.time_range.start) < 1000
        assert abs(profiling.profiler_us(r["t1_ns"], prof) - m.time_range.end) < 1000


def test_counters_hold_every_wrappers_launches(monkeypatch):
    found = []
    for f in sorted(os.listdir(OPS)):
        if f.endswith("_cuda.py"):
            mod = importlib.import_module(f"qb3_tpu_torch.ops.{f[:-3]}")
            with open(os.path.join(OPS, f)) as src:
                found += [(mod, m) for m in re.findall(r"^(\w+)\.launches = 0$", src.read(),
                                                       re.M)]
    assert {"pack_groups_chunked", "chunkwalk8", "extract_windows", "wavefront_fused",
            "wavefront8", "wavefront_wide", "place_parts", "gather_slabs",
            "encode_pack_image"} <= {name for _, name in found}
    for k, (mod, name) in enumerate(found):
        monkeypatch.setattr(getattr(mod, name), "launches", 100 + k)
    c = profiling.counters()
    assert {name: c[name] for _, name in found} == \
        {name: 100 + k for k, (_, name) in enumerate(found)}
    assert set(c) == {name for _, name in found} | {"pipeline.cap_misses", *STAGED, *STRIP}


def test_ring_keeps_the_newest_spans_up_to_its_bound(monkeypatch):
    assert profiling.RING == 65536
    monkeypatch.setattr(profiling, "RING", 16)
    profiling.enable()
    for i in range(40):
        with profiling.span(f"s{i}"):
            pass
    assert [r["name"] for r in profiling.records()] == [f"s{i}" for i in range(24, 40)]


def test_threads_keep_their_own_parents_and_batches():
    """16 threads open nested spans under their own batch ids with a short
    switch interval: every id is unique, every parent is the same thread's
    outer span, every batch the thread's own."""
    profiling.enable()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def body(k):
        for _ in range(200):
            with profiling.batch(1000 + k), profiling.span(f"o{k}"), profiling.span(f"i{k}"):
                pass

    try:
        threads = [threading.Thread(target=body, args=(k,)) for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    rs = profiling.records()
    by_id = {r["id"]: r for r in rs}
    assert len(rs) == len(by_id) == 16 * 400
    for r in rs:
        k = int(r["name"][1:])
        assert r["batch"] == 1000 + k
        if r["name"][0] == "i":
            assert by_id[r["parent"]]["name"] == f"o{k}"
        else:
            assert r["parent"] is None


@pytest.mark.parametrize("path", list(PATHS))
def test_card_spans_have_device_times(cuda, path):
    """On the card: the streams with the tracer on equal those with it off
    and the CPU's; the spans opened on the card carry device ms, the host
    stages none."""
    encode, names = PATHS[path]
    off, cpu = encode(cuda, 21), encode("cpu", 21)
    profiling.enable()
    assert encode(cuda, 21) == off == cpu
    rs = [r for r in profiling.records() if r["name"] in names]
    on_card = {"encode.phase_a", "encode.pack", "batch.upload", "batch.fetch",
               "pipeline.upload"}
    assert {r["name"] for r in rs} >= names
    for r in rs:
        if r["name"] in on_card:
            assert r["device_ms"] is not None and r["device_ms"] >= 0
        else:
            assert r["device_ms"] is None
    assert max(r["device_ms"] for r in rs if r["name"] == "encode.phase_a") > 0


def test_card_strip_spans_have_device_times(cuda):
    """On the card: the strips' stream equals the CPU's with the tracer on;
    strip.quantize (K11, launched once a strip), strip.encode and
    strip.stitch carry device ms, the host stages (strip.bytes among them)
    none."""
    cpu = _dem_strips(Mode.CF_RLE_H)
    profiling.enable()
    launches = quantize_carrier.launches
    assert _dem_strips(Mode.CF_RLE_H, device=cuda) == cpu
    assert quantize_carrier.launches == launches + 12
    rs = profiling.records()
    assert {r["name"] for r in rs} == {"strip.push", "strip.quantize", "strip.encode",
                                       "strip.finish", "strip.stitch", "strip.bytes",
                                       "finish.rle0"}
    for r in rs:
        on_card = r["name"] in ("strip.quantize", "strip.encode", "strip.stitch")
        assert (r["device_ms"] is not None) == on_card
        assert not on_card or r["device_ms"] > 0
