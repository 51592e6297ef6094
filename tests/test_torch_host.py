"""The host modules qb3_tpu_torch copies from qb3_tpu (constants, tables,
container, rle) give the same values and bytes, the RLE0 pass through the
port's C++ library (native.py) gives the Python path's bytes, and importing
the port loads neither jax nor qb3_tpu."""

import subprocess
import sys

import numpy as np
import pytest

from qb3_tpu import constants as jconstants
from qb3_tpu import container as jcontainer
from qb3_tpu import rle as jrle
from qb3_tpu import tables as jtables
from qb3_tpu_torch import constants, container, native, rle, tables

TABLES = ["ENC_SINGLE", "ENC_GROUP", "DEC_SINGLE", "DEC_GROUP", "CSW", "DSW",
          "SIGNAL", "IDX_ENC", "IDX_DEC"]


@pytest.mark.parametrize("name", TABLES)
def test_tables_equal(name):
    np.testing.assert_array_equal(getattr(tables, name), getattr(jtables, name))


def test_constants_equal():
    assert (constants.B, constants.B2, constants.ZCURVE, constants.HILBERT,
            constants.TYPESIZES, constants.QB3_MAXBANDS_EXT) == (
        jconstants.B, jconstants.B2, jconstants.ZCURVE, jconstants.HILBERT,
        jconstants.TYPESIZES, jconstants.QB3_MAXBANDS_EXT)
    for enum in ("DType", "Mode", "Error"):
        assert {e.name: int(e) for e in getattr(constants, enum)} == \
            {e.name: int(e) for e in getattr(jconstants, enum)}
    for m in range(10):
        for f in ("is_fast_mode", "needs_rle", "is_best_mode", "mode_uses_zcurve"):
            assert getattr(constants, f)(m) == getattr(jconstants, f)(m)
    for order in (constants.ZCURVE, constants.HILBERT):
        assert constants.curve_offsets(order) == jconstants.curve_offsets(order)


@pytest.mark.parametrize("nbands,dtype,mode,quanta,order,index,sig", [
    (1, 0, 8, 1, 0, None, b"ix"),
    (3, 2, 4, 7, 0, b"\x01\x02" * 40, b"ic"),
    (3, 6, 0, 1, constants.ZCURVE, None, b"ix"),
    (5, 7, 8, 300, constants.HILBERT, b"\x05" * 70000, b"ix"),
    (2, 1, 255, 2, 0, None, b"ix"),
    (256, 4, 6, 1 << 20, 0, b"\x00\xff" * 10, b"ib"),
])
def test_headers_equal(nbands, dtype, mode, quanta, order, index, sig):
    cband = [(i + 1) % nbands if i % 2 else i for i in range(nbands)]
    args = (37, 19, nbands, dtype, mode, cband, quanta, order, index, sig)
    hdr = container.write_headers(*args)
    assert hdr == jcontainer.write_headers(*args)
    stream = hdr + b"\x00" * 16
    assert vars(container.parse_headers(stream)) == vars(jcontainer.parse_headers(stream))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rle_equal(seed):
    rng = np.random.default_rng(seed)
    # runs of zeros and 0xff amid literals: every escape rule fires
    parts = [rng.integers(0, 256, rng.integers(1, 9), dtype=np.uint8).tobytes()
             if k % 3 else bytes([0xFF * (k % 2)]) * int(rng.integers(2, 300))
             for k in range(200)]
    data = b"".join(parts)
    packed = rle.rle0_encode(data)
    assert packed == jrle.rle0_encode(data)
    assert rle.rle0_decoded_size(packed) == jrle.rle0_decoded_size(packed) == len(data)
    assert rle.rle0_decode(packed, len(data)) == data


def _rle_buffers(seed):
    """Random buffers of zero floods, 0xff floods, mixed escapes, runs
    straddling the 258-zero limit and the boundary shapes."""
    rng = np.random.default_rng(seed)
    for trial in range(120):
        n = int(rng.integers(0, 400))
        style = trial % 5
        if style == 0:
            buf = rng.integers(0, 256, n, dtype=np.uint8)
        elif style == 1:
            buf = rng.choice(np.array([0, 0, 0, 0, 0xFF, 0xFF, 1], np.uint8), n)
        elif style == 2:
            buf = np.zeros(n, np.uint8)
        elif style == 3:
            buf = np.full(n, 0xFF, np.uint8)
        else:
            buf = rng.choice(np.array([0, 0xFF], np.uint8), n)
        yield buf.tobytes()
    for n in (0, 1, 2, 3, 257, 258, 259, 300, 1000):
        yield bytes(n)
    yield from (b"\xff\xff\x00", b"\xff\x00\x00\x00\x00\x00", b"\x00\x00\x00\x00\xff")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rle0_native_equals_python(seed):
    """The C++ RLE0 pass writes the Python path's bytes, expands them back,
    sizes them alike, and rejects an overflowing run."""
    if not native.available():
        pytest.skip("no C++ compiler: the native library does not build")
    for data in _rle_buffers(seed):
        packed = rle._rle0_encode_py(data)
        assert native.rle0_encode(data) == packed == rle.rle0_encode(data)
        assert native.rle0_decode(packed, len(data)) == data == rle._rle0_decode_py(packed, len(data))
        assert native.rle0_size(packed) == len(data)
    with pytest.raises(ValueError):
        native.rle0_decode(b"\xff\xff\xf0" + b"x" * 8, 10)


@pytest.mark.parametrize("mode", ["RLE_H", "RLE"])
def test_rle_streams_equal_with_and_without_native(mode, monkeypatch):
    """An RLE stream round trip: the same bytes with the C++ pass and with
    the Python path, and the decode of either gives the image."""
    import qb3_tpu_torch as qt

    img = np.zeros((48, 40, 2), np.uint8)
    img[8:20, 4:36] = np.random.default_rng(5).integers(0, 256, (12, 32, 2), dtype=np.uint8)
    img[30:34, 10:12] = 0xFF
    stream = qt.encode(img, mode=constants.Mode[mode], device="cpu")
    assert container.parse_headers(stream).mode == constants.Mode[mode]
    np.testing.assert_array_equal(qt.decode(stream, device="cpu")[0], img)
    monkeypatch.setattr(native, "available", lambda: False)
    assert qt.encode(img, mode=constants.Mode[mode], device="cpu") == stream
    np.testing.assert_array_equal(qt.decode(stream, device="cpu")[0], img)


def test_kernels_bind_once_at_first_launch():
    """Importing the wrappers builds and binds nothing; every C entry point
    of _build.SIGNATURES has one module-level binding; a bound entry point's
    CUDA error raises with its name, and 0 passes."""
    code = ("import qb3_tpu_torch.probes; from qb3_tpu_torch import _build; "
            "from qb3_tpu_torch.ops import (chunkwalk_cuda, encode_cuda, fusedwin_cuda, "
            "gather_cuda, pack_cuda, place_cuda, probe_cuda, wavefront_cuda); "
            "ks = [v for m in (chunkwalk_cuda, encode_cuda, fusedwin_cuda, gather_cuda, "
            "pack_cuda, place_cuda, probe_cuda, wavefront_cuda) for v in vars(m).values() "
            "if isinstance(v, _build.Kernel)]; "
            "assert sorted(k.name for k in ks) == sorted(_build.SIGNATURES), ks; "
            "assert all(k.fn is None for k in ks); "
            "assert _build._LIB is None")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
    from qb3_tpu_torch import _build

    k = _build.Kernel("qb3_gather_slabs")
    k.fn = lambda *args: 0
    assert k(1, 2) is None
    k.fn = lambda *args: 700
    with pytest.raises(RuntimeError, match="qb3_gather_slabs: CUDA error 700"):
        k(1, 2)


def test_load_builds_once_from_many_threads(monkeypatch):
    """Sixteen threads (more than this machine's cores) that reach
    _build.load at once, with a short switch interval (the shards of
    parallel/sharded.py at their first kernel), build and load the library
    once, under the module's lock, and all get the same handle."""
    import ctypes
    import threading
    import time
    from types import SimpleNamespace

    from qb3_tpu_torch import _build

    builds, opened = [], []

    def build():
        builds.append(threading.get_ident())
        time.sleep(0.2)  # a slow build: the other threads arrive meanwhile
        return "libfake.so"

    def open_lib(path):
        opened.append(path)
        return SimpleNamespace(**{name: SimpleNamespace() for name in _build.SIGNATURES})

    monkeypatch.setattr(_build, "_LIB", None)
    monkeypatch.setattr(_build, "build", build)
    monkeypatch.setattr(ctypes, "PyDLL", open_lib)
    start = threading.Barrier(16)
    got = []

    def worker():
        start.wait()
        got.append(_build.load())

    threads = [threading.Thread(target=worker) for _ in range(16)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(builds) == 1 and opened == ["libfake.so"]
    assert len(got) == 16 and all(g is got[0] for g in got)
    assert got[0].qb3_pack_groups.restype is ctypes.c_int


def test_import_loads_no_jax():
    code = ("import sys, qb3_tpu_torch, qb3_tpu_torch.batch, qb3_tpu_torch.benchutil, "
            "qb3_tpu_torch._build, qb3_tpu_torch.ops.chunkwalk_cuda, "
            "qb3_tpu_torch.ops.pack_cuda, qb3_tpu_torch.ops.gather_cuda, "
            "qb3_tpu_torch.ops.place_cuda, qb3_tpu_torch.stitch, qb3_tpu_torch.strip, "
            "qb3_tpu_torch.native, qb3_tpu_torch.offsets, qb3_tpu_torch.pipeline, "
            "qb3_tpu_torch.foreign, qb3_tpu_torch.profiling, qb3_tpu_torch.pngio, "
            "qb3_tpu_torch.cli, qb3_tpu_torch.lite, qb3_tpu_torch.parallel, "
            "qb3_tpu_torch.parallel.sharded; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'qb3_tpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


class _FakeProfile:
    """torch.profiler.profile's stand-in: each profile yields the next of
    the given event lists, each event a (device type, name, us) tuple."""

    def __init__(self, takes):
        self.takes = iter(takes)

    def __call__(self, activities):
        from contextlib import nullcontext
        from types import SimpleNamespace

        evs = [SimpleNamespace(device_type=d, name=n,
                               time_range=SimpleNamespace(elapsed_us=lambda us=us: us,
                                                          start=0, end=us))
               for d, n, us in next(self.takes)]
        return nullcontext(SimpleNamespace(events=lambda: evs))


@pytest.mark.parametrize("lost", [0, 1, 4, 5, "empty"])
def test_device_profile_retakes_profiles_that_lost_records(lost, monkeypatch):
    """A profile missing a device kernel for a recorded launch (all of them
    lost, or part) is taken again, five times at most; the one kept gives
    the per-call numbers: the first whole one, else the one with the most
    kernels (lost counts what it lacks).  Five empty profiles raise.  The
    sentinel kernels each profile launches first are left out, whether
    their records came or not."""
    import torch
    import torch.profiler
    from torch.autograd import DeviceType

    from qb3_tpu_torch import benchutil

    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    launch = (cpu, "cudaLaunchKernel", 1.0)
    whole = [launch, launch, (cuda, "walk", 30.0), (cuda, "walk", 50.0),
             (cuda, "Memset (Device)", 2.0), (cuda, "Memset (Device)", 2.0)]
    part = [launch, launch, (cuda, "walk", 30.0), (cuda, "Memset (Device)", 2.0),
            (cuda, "Memset (Device)", 2.0)]
    if lost == "empty":
        takes = [[launch, launch]] * 5
    else:
        takes = [[[launch, launch], part][i % 2] for i in range(lost)] + [whole] * (5 - lost)
    sentinel = (cuda, "at::cuda::(anonymous namespace)::spin_kernel(long)", 9.0)
    takes = [[launch] * benchutil._PROFILE_SENTINELS + [sentinel] * (i % 3 * 5) + t
             for i, t in enumerate(takes)]
    monkeypatch.setattr(torch.profiler, "profile", _FakeProfile(takes))
    monkeypatch.setattr(torch.cuda, "_sleep", lambda cycles: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(benchutil, "_require_cuda", lambda: None)
    monkeypatch.setattr(benchutil, "_PROFILE_PAD_S", 0.0)
    if lost == "empty":
        with pytest.raises(RuntimeError, match="five profiles recorded no device activity"):
            benchutil.device_profile(lambda: None, 2)
        return
    p = benchutil.device_profile(lambda: None, 2)
    assert p["attempts"] == min(lost + 1, 5)
    if lost == 5:  # the partial profile, kept with what it lacks
        assert p["lost"] == 1 and p["ops"] == 1.5
        assert p["per_op"] == pytest.approx({"walk": 0.015, "Memset (Device)": 0.002})
        return
    assert p["lost"] == 0 and p["ops"] == 2 and p["top"] == "walk"
    assert p["per_op"] == pytest.approx({"walk": 0.04, "Memset (Device)": 0.002})


def test_device_profile_active_time_is_the_union_of_records():
    """active_ms counts the time at least one device record ran: overlaps
    between streams once, gaps not at all."""
    from qb3_tpu_torch.benchutil import _union_ms

    assert _union_ms([]) == 0
    assert _union_ms([(0, 10), (5, 20), (30, 40), (32, 35)]) == pytest.approx(0.030)
    assert _union_ms([(30, 40), (0, 10), (10, 12)]) == pytest.approx(0.022)
