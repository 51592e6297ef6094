"""qb3_tpu_torch.cli, pngio and profiling on the CPU.  The port's CLI
(``--device cpu``) writes the same .qb3 files as qb3_tpu.cli and the same
decoded PNG and .npy files, for u8, u16 and u32 .npy inputs, 8- and 16-bit
PNGs, the options -b, -q +4, -r, -l, -m and --index, and a folder; the
pngio copy reads and writes the bytes qb3_tpu.pngio does; profiling's meter
and trace run on the CPU.  The tolerance is zero: files are equal."""

import json
import os
import shutil

import numpy as np
import pytest

import qb3_tpu_torch as qt
from qb3_tpu import cli as jcli
from qb3_tpu import pngio as jpngio
from qb3_tpu_torch import cli, pngio, profiling

from . import corpus

INPUTS = {  # name -> image
    "u8": lambda: corpus.natural8(32, 40, 3, seed=230),
    "u16": lambda: corpus.to_type(corpus.natural8(24, 28, 1, seed=231), np.uint16, 257),
    "u32": lambda: corpus.to_type(corpus.natural8(20, 24, 2, seed=232), np.uint32, 65537),
}


def _same_file(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def _both(tmp_path, src, flags):
    """Encode src with both CLIs and decode each result with its own CLI:
    the .qb3 files and the decoded files must be equal."""
    outs = {}
    for name, main, extra in (("j", jcli.main, []), ("t", cli.main, ["--device", "cpu"])):
        q = str(tmp_path / f"{name}.qb3")
        assert main([src, q, *flags, *extra]) == 0
        assert main(["-d", q, str(tmp_path / f"{name}-out.png"), *extra]) == 0
        outs[name] = q
    assert _same_file(outs["j"], outs["t"])
    decoded = sorted(f for f in os.listdir(tmp_path) if f.startswith("t-out"))
    assert decoded
    for f in decoded:
        assert _same_file(tmp_path / f, tmp_path / ("j" + f[1:]))


@pytest.mark.parametrize("flags", [[], ["-b"], ["-q", "+4"], ["-r"], ["-l"], ["--index"]],
                         ids=["ftl", "best", "quanta", "rle", "legacy", "index"])
@pytest.mark.parametrize("name", list(INPUTS))
def test_npy_files_equal_qb3_tpus(tmp_path, name, flags):
    src = str(tmp_path / "in.npy")
    np.save(src, INPUTS[name]())
    _both(tmp_path, src, flags)


def test_bandmix_equals_qb3_tpus(tmp_path):
    src = str(tmp_path / "rgb.npy")
    np.save(src, INPUTS["u8"]())
    _both(tmp_path, src, ["-m", "-v"])


@pytest.mark.parametrize("bits", [8, 16])
def test_png_files_equal_qb3_tpus(tmp_path, bits):
    img = corpus.natural8(32, 36, 3, seed=233)
    src = str(tmp_path / "in.png")
    if bits == 8:
        pytest.importorskip("PIL.Image").fromarray(img).save(src)
    else:
        pngio.write_png(src, corpus.to_type(img, np.uint16, 250))
    _both(tmp_path, src, [])


def test_folder_equals_qb3_tpus(tmp_path):
    """A folder run converts every .npy / .png to .qb3 and every .qb3 back."""
    for side in ("j", "t"):
        os.makedirs(tmp_path / side)
        for i in range(2):
            np.save(tmp_path / side / f"a{i}.npy", corpus.natural8(16, 20, 1, seed=234 + i))
        pngio.write_png(str(tmp_path / side / "b.png"),
                        corpus.to_type(corpus.natural8(16, 16, 3, seed=236), np.uint16, 3))
    assert jcli.main([str(tmp_path / "j"), "-v"]) == 0
    assert cli.main([str(tmp_path / "t"), "-v", "--device", "cpu"]) == 0
    names = sorted(os.listdir(tmp_path / "t"))
    assert names == sorted(os.listdir(tmp_path / "j"))
    assert {"a0.qb3", "a1.qb3", "b.qb3"} <= set(names)
    for side in ("j", "t"):  # and back
        for f in ("a0", "a1", "b"):
            shutil.move(tmp_path / side / f"{f}.qb3", tmp_path / side / f"{f}-2.qb3")
    assert jcli.main([str(tmp_path / "j")]) == 0
    assert cli.main([str(tmp_path / "t"), "--device", "cpu"]) == 0
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j"))
    for f in os.listdir(tmp_path / "t"):
        assert _same_file(tmp_path / "t" / f, tmp_path / "j" / f), f


@pytest.mark.parametrize("shape,dtype", [((24, 20, 1), np.uint8), ((24, 20, 3), np.uint8),
                                         ((20, 24, 1), np.uint16), ((16, 20, 3), np.uint16),
                                         ((16, 16, 4), np.uint16)])
def test_pngio_writes_and_reads_qb3_tpus_bytes(tmp_path, shape, dtype):
    img = corpus.to_type(corpus.natural8(*shape, seed=237), dtype, 201 if dtype == np.uint16
                         else 1)
    ours, theirs = str(tmp_path / "t.png"), str(tmp_path / "j.png")
    pngio.write_png(ours, img)
    jpngio.write_png(theirs, img)
    assert _same_file(ours, theirs)
    data = open(ours, "rb").read()
    assert pngio.probe(data) == jpngio.probe(data)
    back = pngio._read_pure(data)
    np.testing.assert_array_equal(back, jpngio._read_pure(data))
    np.testing.assert_array_equal(back.reshape(img.shape), img)


def test_pngio_reads_pillows_filters_as_qb3_tpu(tmp_path):
    """Pillow writes adaptively filtered scanlines (sub, up, avg, paeth)."""
    image = pytest.importorskip("PIL.Image")
    img = corpus.natural8(64, 48, 3, seed=238)
    p = str(tmp_path / "f.png")
    image.fromarray(img).save(p)
    np.testing.assert_array_equal(pngio.read_png(p), jpngio.read_png(p))
    np.testing.assert_array_equal(pngio._read_pure(open(p, "rb").read()), img)


def test_meter_gives_a_rate_on_the_cpu():
    with profiling.meter(4_000_000) as m:
        sum(range(10_000))
    assert m.seconds > 0 and m.mbps == pytest.approx(4.0 / m.seconds)


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    """The CLI's --trace writes one Chrome trace of the run into DIR."""
    src = str(tmp_path / "in.npy")
    np.save(src, INPUTS["u8"]())
    assert cli.main([src, str(tmp_path / "x.qb3"), "--device", "cpu",
                     "--trace", str(tmp_path / "tr")]) == 0
    (name,) = os.listdir(tmp_path / "tr")
    assert name.endswith(".pt.trace.json")
    with open(tmp_path / "tr" / name) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)


@pytest.mark.parametrize("host", [False, True])
def test_trace_takes_qb3_tpus_host_keyword(tmp_path, host):
    """trace(d, host=...) as qb3_tpu takes it: one Chrome trace, CPU
    activity recorded either way."""
    with profiling.trace(str(tmp_path), host=host):
        qt.encode(INPUTS["u8"](), device="cpu")
    (name,) = os.listdir(tmp_path)
    assert name.endswith(".pt.trace.json")
    with open(tmp_path / name) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)
