"""Decode without a sidecar, and of best-mode streams with the "ib"
sidecar, in qb3_tpu_torch against qb3_tpu, on the CPU: the serial walk
(offsets.py and the C++ walk of native.py), K7's plain twin (ops/gather_cuda)
against the TPU kernel gather_slabs run in interpret mode, decode_groups
against qb3_tpu's decode_groups_fused / decode_groups on fast and best-mode
groups (CF, CF0, IDX), and the public decode of valid FTL, BASE and best
streams, the web fixtures, the Landsat sample and damaged streams.  Inputs
are made with numpy from a seed; the tolerance is zero.
"""

import base64
import functools
import hashlib
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qb3_tpu
import qb3_tpu_torch as qt
from qb3_tpu import container
from qb3_tpu import native as j_native
from qb3_tpu import offsets as j_offsets
from qb3_tpu import rle as j_rle
from qb3_tpu.constants import TYPESIZES, Mode, is_best_mode
from qb3_tpu.ops import decode as jdecode
from qb3_tpu.ops.pack_pallas import gather_slabs as j_gather_slabs
from qb3_tpu_torch import api, native, offsets
from qb3_tpu_torch.benchutil import LANDSAT_SAMPLE, LANDSAT_SHA256, headline_image
from qb3_tpu_torch.ops import decode as tdecode
from qb3_tpu_torch.ops.gather_cuda import gather_slabs, gather_slabs_plain, gather_span

from . import corpus
from .test_torch_wavefront import _spiky, best_scene, xla_groups

CPU = "cpu"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rung63_u64():
    """Smooth u64 with two values at the top of the range: rung-63 groups,
    the 65-bit long code."""
    img = corpus.natural8(20, 24, 1, seed=80).astype(np.uint64)
    img[0, 0, 0] = (1 << 63) | (1 << 62)
    img[4, 8, 0] = (1 << 64) - 1
    return img


def _rle_scene():
    """A u8 scene with a no-data rectangle: zero runs the RLE0 pass takes."""
    img = corpus.natural8(40, 36, 2, seed=81)
    img[4:36, 4:32] = 0
    return img


# name -> (image, encode keyword arguments); every stream has no sidecar
CASES = {
    "u8-ftl-rgb": (lambda: _spiky(corpus.natural8(36, 28, 3, seed=82)), {}),
    "i8-base-h": (lambda: (corpus.natural8(29, 37, 1, seed=83).astype(np.int16) - 128)
                  .astype(np.int8), {"mode": Mode.BASE_H}),
    "u8-base-z-8-bands": (lambda: corpus.natural8(20, 24, 8, seed=84), {"mode": Mode.BASE_Z}),
    "u8-rle-h": (_rle_scene, {"mode": Mode.RLE_H}),
    "u8-2x20": (lambda: corpus.natural8(2, 20, 3, seed=85) // 16, {}),
    "u8-quanta": (lambda: corpus.natural8(24, 28, 1, seed=86), {"quanta": 4}),
    "u16-base-h-3-bands": (lambda: _spiky(headline_image(30, 26, 3, seed=87, dtype=np.uint16)),
                           {"mode": Mode.BASE_H}),
    "i16-ftl-quanta": (lambda: (corpus.natural8(24, 24, 1, seed=88).astype(np.int16) - 120)
                       .astype(np.int16), {"quanta": 7, "away": True}),
    "u32-base-z": (lambda: _spiky(headline_image(21, 18, 1, seed=89, dtype=np.uint32)),
                   {"mode": Mode.BASE_Z}),
    "u64-ftl-3-bands": (lambda: headline_image(17, 23, 3, seed=90, dtype=np.uint64), {}),
    "u64-rung63": (_rung63_u64, {}),
    "i64-base-h": (lambda: (corpus.natural8(16, 20, 1, seed=91).astype(np.int64)
                            * -(1 << 30)).astype(np.int64), {"mode": Mode.BASE_H}),
}


def _payload(stream):
    """(payload after the RLE0 pass is undone, info, nblocks) of a stream."""
    info = container.parse_headers(stream)
    data = stream[info.data_offset:]
    if info.mode in (Mode.RLE, Mode.RLE_H, Mode.CF_RLE, Mode.CF_RLE_H):
        data = j_rle.rle0_decode(data, j_rle.rle0_decoded_size(data))
    h, w = info.ysize, info.xsize
    if h < 4 or w < 4:
        ngroups = (h * w + 15) // 16
        h, w = (ngroups * 4, 4) if w < 4 else (4, ngroups * 4)
    return data, info, ((h + 3) // 4) * ((w + 3) // 4)


def _assert_walks_equal(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v), err_msg=k)


WALK_STREAMS = {  # name -> stream
    "u8-ftl": lambda: qb3_tpu.encode(_spiky(corpus.natural8(28, 32, 3, seed=92))),
    "u16-base-h": lambda: qb3_tpu.encode(headline_image(24, 20, 2, seed=93, dtype=np.uint16),
                                         mode=Mode.BASE_H),
    "u64-rung63": lambda: qb3_tpu.encode(_rung63_u64()),
    "u8-cf-h": lambda: qb3_tpu.encode(corpus.natural8(24, 24, 2, seed=94) // 5 * 5,
                                      mode=Mode.CF_H),
    "u16-cf-h": lambda: qb3_tpu.encode(
        np.array([0, 1 << 11, 3 << 11, 7 << 11], np.uint16)[
            np.random.default_rng(95).integers(0, 4, (24, 24, 1))], mode=Mode.CF_H),
}


@pytest.mark.parametrize("name", list(WALK_STREAMS))
def test_parse_offsets_equal(name):
    """The port's Python walk returns qb3_tpu's dict, array for array, on
    FTL, BASE and best-mode (CF, CF0, IDX) payloads, and on a truncated one."""
    data, info, nblocks = _payload(WALK_STREAMS[name]())
    tsize = TYPESIZES[info.dtype]
    for payload in (data, data[: len(data) // 2]):
        want = j_offsets.parse_offsets(payload, nblocks, info.nbands, tsize, info.mode)
        got = offsets.parse_offsets(payload, nblocks, info.nbands, tsize, info.mode)
        _assert_walks_equal(got, want)
    if name == "u8-cf-h":
        assert (want["kind"] == offsets.KIND_IDX).any()


@pytest.mark.parametrize("name", list(WALK_STREAMS))
def test_native_walk_equal(name):
    """The port's C++ walk (built from native/qb3xs.cpp and the port's
    tables into build/) returns qb3_tpu's Python walk's result, key for key,
    and qb3_tpu's own C++ walk's where that one loaded (qb3_tpu builds it
    with make at import, and the build can fail: the comparison with the
    Python walk never depends on it)."""
    if not native.available():
        pytest.skip("no C++ compiler: the native walk does not build")
    data, info, nblocks = _payload(WALK_STREAMS[name]())
    tsize = TYPESIZES[info.dtype]
    args = (data, nblocks, info.nbands, tsize, info.mode == Mode.FTL)
    got = native.parse_offsets_native(*args)
    want = j_offsets.parse_offsets(data, nblocks, info.nbands, tsize, info.mode)
    assert not got["failed"]
    for k, v in got.items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    if j_native.available():
        _assert_walks_equal(got, j_native.parse_offsets_native(*args))
    assert native.build().startswith(os.path.join(ROOT, "build", "qb3_tpu_torch"))


def test_native_tables_equal_the_generated_file(tmp_path):
    """The decode tables the port compiles into its C++ walk (native.tables_inc,
    from the port's tables) are the text tools/gen_tables_c.py writes from
    qb3_tpu's tables."""
    spec = importlib.util.spec_from_file_location(
        "gen_tables_c", os.path.join(ROOT, "tools", "gen_tables_c.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    gen.main(str(tmp_path / "tables.inc"))
    assert native.tables_inc() == (tmp_path / "tables.inc").read_text()


def test_native_walk_end_pos_after_failure():
    """A failed walk: the C++ walk reports end_pos 0, the Python walk its
    cursor, in both packages (the decoders raise before reading it)."""
    if not native.available():
        pytest.skip("no C++ compiler: the native walk does not build")
    data = np.random.default_rng(1).integers(0, 256, 20000, dtype=np.uint8).tobytes()
    py = offsets.parse_offsets(data, 400, 2, 1, Mode.CF_H)  # random u8 best-mode groups
    nat = native.parse_offsets_native(data, 400, 2, 1, False)
    assert nat["failed"] and py["failed"] and nat["failed_group"] == py["failed_group"]
    assert nat["end_pos"] == 0 < py["end_pos"]
    tail = np.asarray(nat["kind"]).reshape(-1)[nat["failed_group"] + 1:]
    assert (tail == offsets.KIND_ZERO).all()


@pytest.mark.parametrize("W,seed", [(8, 0), (36, 1)])
def test_k7_twin_matches_pallas_kernel(W, seed):
    """gather_slabs_plain against the TPU kernel in interpret mode: 256
    groups at sorted word offsets, 64 per grid step."""
    rng = np.random.default_rng(seed)
    G, ngroups = 64, 256
    base = np.sort(rng.integers(0, 40 * ngroups, ngroups)).astype(np.int32)
    span = max(int(base[t + G - 1] - (base[t] // 128) * 128) for t in range(0, ngroups, G))
    R = -(-(span + W + 128) // 128) * 128
    words = rng.integers(0, 1 << 32, int(base[-1]) + R + 128, dtype=np.uint64).astype(np.uint32)
    want = np.asarray(j_gather_slabs(jnp.asarray(words), jnp.asarray(base), G, W, R,
                                     interpret=True, sub=16))
    words32 = torch.from_numpy(words.view(np.int32))
    before = gather_slabs.launches
    got = gather_slabs(words32, torch.from_numpy(base), W, gather_span(base, W))
    assert gather_slabs.launches == before  # CPU: the twin
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), words[base[:, None] + np.arange(W)])


def test_k7_twin_reads_zero_outside_the_stream():
    words = torch.arange(1, 41, dtype=torch.int32)
    base = torch.tensor([-3, 0, 35, 40, 1000], dtype=torch.int32)
    got = gather_slabs_plain(words, base, 8).numpy()
    idx = base.numpy()[:, None].astype(np.int64) + np.arange(8)
    np.testing.assert_array_equal(got, np.where((idx >= 0) & (idx < 40), idx + 1, 0))
    # the widest block: from its first base rounded down to 4, plus W, to a multiple of 4
    assert gather_span(np.array([5, 9, 300]), 8, G=2) == 16  # 9 - 4 + 8; then 300 - 300 + 8
    assert gather_span(np.array([5, 9, 300]), 8, G=3) == 304  # 300 - 4 + 8
    assert gather_span(np.array([5, 9, 300]), 8, G=3, cap=64) == 64


def _rle_best_scene():
    """best_scene with a no-data band of zero rows: zero runs the RLE0 pass
    takes."""
    img = best_scene(24, 20, 2, np.uint8, seed=70)
    img[8:20] = 0
    return img


# name -> (image, encode keyword arguments, whether the walk meets CF, CF0
# and IDX groups); every stream is best mode, with no sidecar or with "ib"
BEST_CASES = {
    "u8-cf-h": (lambda: best_scene(24, 20, 1, np.uint8, seed=71), {"mode": Mode.CF_H}, True),
    "u8-cf-h-rgb": (lambda: best_scene(24, 20, 3, np.uint8, seed=72), {"mode": Mode.CF_H},
                    False),
    "u8-cf-rle-z": (_rle_best_scene, {"mode": Mode.CF_RLE}, False),
    "u8-cf-h-3x160": (lambda: (np.arange(480) % 7 * 12 + 40).reshape(3, 160, 1).astype(np.uint8),
                      {"mode": Mode.CF_H}, False),
    "u16-cf-h-2-bands": (lambda: best_scene(24, 20, 2, np.uint16, seed=74),
                         {"mode": Mode.CF_H}, True),
    "u16-cf-h-quanta": (lambda: headline_image(20, 24, 1, seed=75, dtype=np.uint16),
                        {"mode": Mode.CF_H, "quanta": 3}, False),
    "u32-cf-rle-h": (lambda: best_scene(24, 20, 1, np.uint32, seed=76, step=1000),
                     {"mode": Mode.CF_RLE_H}, True),
    "u64-cf-z": (lambda: best_scene(24, 20, 1, np.uint64, seed=77, step=1000),
                 {"mode": Mode.CF}, False),
}


@functools.cache
def _best_stream(name, ib):
    make, kw, _ = BEST_CASES[name]
    return make(), qb3_tpu.encode(make(), index=ib, **kw)


@functools.cache
def _best_reference(name, ib):
    """qb3_tpu's decode of _best_stream, shared by both walks' cases."""
    return qb3_tpu.Decoder(_best_stream(name, ib)[1]).read_data()


@pytest.mark.parametrize("path", ["native-walk", "python-walk", "ib"])
@pytest.mark.parametrize("name", list(BEST_CASES))
def test_best_decode_equals_qb3_tpu(name, path, monkeypatch):
    """Best-mode streams (CF, CF_H, CF_RLE, CF_RLE_H; u8 to u64; 1-3 bands;
    quanta; a small image) decode to qb3_tpu's arrays: without a sidecar by
    each of the port's walks, pinned, then K7 and K5; with the "ib" sidecar
    by K7 and K5 on its metadata."""
    _, kw, all_kinds = BEST_CASES[name]
    img, stream = _best_stream(name, path == "ib")
    info = container.parse_headers(stream)
    assert info.mode == kw["mode"] and info.index is None and info.index_chunked is None
    assert (info.index_best is not None) == (path == "ib")
    if path == "python-walk":
        monkeypatch.setattr(native, "available", lambda: False)
        data, _, nblocks = _payload(stream)
        walk = offsets.parse_offsets(data, nblocks, info.nbands, img.itemsize, info.mode)
        kinds = set(np.unique(walk["kind"]))
        assert {offsets.KIND_CF, offsets.KIND_CF0, offsets.KIND_IDX} <= kinds or not all_kinds
    elif path == "native-walk" and not native.available():
        pytest.skip("no C++ compiler: the native walk does not build")
    ours = qt.Decoder(stream, device=CPU)
    out = ours.read_data()
    np.testing.assert_array_equal(out, _best_reference(name, path == "ib"))
    assert out.dtype == img.dtype and not ours.failed and ours.decode_path == path
    if "quanta" not in kw:
        np.testing.assert_array_equal(out, img.reshape(out.shape))


def test_landsat_sample_decodes_to_its_pin():
    """LANDSAT_SHA256, the pin chip_smoke.py checks on the card, re-derived
    from qb3_tpu.decode (a few seconds here with either of its walks), and
    the port's CPU decode (its walk, then K7's and K5's twins) held to it."""
    with open(os.path.join(ROOT, LANDSAT_SAMPLE), "rb") as f:
        stream = f.read()
    info = container.parse_headers(stream)
    assert info.mode == Mode.CF_H and info.index_best is None and info.index is None
    want, _ = qb3_tpu.decode(stream)
    assert hashlib.sha256(want.tobytes()).hexdigest() == LANDSAT_SHA256
    dec = qt.Decoder(stream, device=CPU)
    out = dec.read_data()
    assert out.shape == (512, 512, 8) and out.dtype == np.uint16
    assert hashlib.sha256(out.tobytes()).hexdigest() == LANDSAT_SHA256
    assert dec.decode_path in ("native-walk", "python-walk") and not dec.failed


@pytest.mark.parametrize("name", ["u8-ftl-rgb", "u8-base-z-8-bands", "u16-base-h-3-bands",
                                  "u32-base-z", "u64-rung63", "i64-base-h", "u8-cf-h",
                                  "u16-cf-h-2-bands", "u32-cf-rle-h", "u64-cf-z"])
def test_decode_groups_matches_jax(name):
    """decode_groups (K7's and K5's twins) against qb3_tpu's decode_groups_fused
    (u8/u16, the gather without the MXU) and decode_groups (u32/u64) on the
    same walk, of FTL and BASE streams and of best-mode ones."""
    if name in BEST_CASES:
        img, stream = _best_stream(name, False)
        data, info, nblocks = _payload(stream)
        tbits = 8 * img.itemsize
        meta = offsets.parse_offsets(data, nblocks, info.nbands, tbits // 8, info.mode)
        got = tdecode.decode_groups(**api.walk_inputs(meta, api.padded_words(data), tbits, CPU),
                                    tbits=tbits, apply_step=True)
        np.testing.assert_array_equal(got.numpy().view(np.uint64),
                                      xla_groups(api.padded_words(data), meta, tbits, True))
        return
    make, kw = CASES[name]
    img = make()
    data, info, nblocks = _payload(qb3_tpu.encode(img, **kw))
    tbits = 8 * img.dtype.itemsize
    meta = offsets.parse_offsets(data, nblocks, info.nbands, tbits // 8, info.mode)
    words = api.padded_words(data)
    apply_step = info.mode != Mode.FTL
    got = tdecode.decode_groups(**api.walk_inputs(meta, words, tbits, CPU), tbits=tbits,
                                apply_step=apply_step)
    flat = [jnp.asarray(meta[k].reshape(-1)) for k in ("kind", "val_pos", "vrung", "cf")]
    w32 = jnp.asarray(words.view(np.uint32))
    if tbits <= 16:
        want = jax.jit(jdecode.decode_groups_fused, static_argnums=(5, 6, 7))(
            w32, *flat, apply_step, tbits, False)
    else:
        want, _ = jax.jit(jdecode.decode_groups, static_argnums=(5,))(w32, *flat, apply_step)
    np.testing.assert_array_equal(got.numpy().view(np.uint64), np.asarray(want).astype(np.uint64))


@pytest.mark.parametrize("walk", ["native", "python"])
@pytest.mark.parametrize("name", list(CASES))
def test_decode_equals_qb3_tpu(name, walk, monkeypatch):
    make, kw = CASES[name]
    img = make()
    stream = qb3_tpu.encode(img, **kw)
    info = container.parse_headers(stream)
    assert info.index is None and info.index_chunked is None and info.mode != Mode.STORED
    if name == "u8-rle-h":
        assert info.mode == Mode.RLE_H
    if walk == "python":
        monkeypatch.setattr(native, "available", lambda: False)
    ours = qt.Decoder(stream, device=CPU)
    theirs = qb3_tpu.Decoder(stream)
    out = ours.read_data()
    np.testing.assert_array_equal(out, theirs.read_data())
    assert out.dtype == img.dtype and not ours.failed
    assert ours.decode_path == f"{walk}-walk"
    if "quanta" not in kw:
        np.testing.assert_array_equal(out, img.reshape(out.shape))
    assert qt.encode(img, device=CPU, **kw) == stream  # the default: no sidecar


def _fixtures():
    with open(os.path.join(ROOT, "web", "test", "fixtures.js")) as f:
        text = f.read()
    return {c["name"]: c for c in json.loads(text[text.index("["): text.rindex("]") + 1])}


FIXTURES = _fixtures()


@pytest.mark.parametrize("name", list(FIXTURES))
def test_web_fixture_decodes_to_raw(name):
    """Every web fixture, the three best-mode ones included, decodes to its
    raw bytes."""
    c = FIXTURES[name]
    stream = base64.b64decode(c["stream"])
    dec = qt.Decoder(stream, device=CPU)
    out = dec.read_data()
    assert list(out.shape) == c["shape"] and str(out.dtype) == c["dtype"]
    assert out.tobytes() == base64.b64decode(c["raw"])
    if is_best_mode(container.parse_headers(stream).mode):
        assert dec.decode_path in ("native-walk", "python-walk", "ib")


DAMAGED = {  # name -> (image, mode)
    "u8-ftl-3-bands": (lambda: headline_image(32, 28, 3, seed=96), Mode.FTL),
    "u8-base-h": (lambda: headline_image(24, 28, 2, seed=97), Mode.BASE_H),  # flip-64: CF, IDX
    "u16-base-h": (lambda: headline_image(24, 28, 2, seed=97, dtype=np.uint16), Mode.BASE_H),
    "u64-ftl": (lambda: _spiky(headline_image(20, 24, 1, seed=98, dtype=np.uint64)), Mode.FTL),
}


def _damage(stream, damage):
    info = container.parse_headers(stream)
    n = len(stream) - info.data_offset
    if damage.startswith("truncated"):
        return stream[: info.data_offset + n * int(damage[-2:]) // 100]
    if damage == "garbage":
        return stream + bytes(np.random.default_rng(99).integers(0, 256, 8, dtype=np.uint8))
    at = info.data_offset + n * int(damage[-2:]) // 100  # "flip-NN": a bit NN% in
    return stream[:at] + bytes([stream[at] ^ (1 << (at % 8))]) + stream[at + 1:]


def _read(dec_cls, stream):
    try:
        dec = dec_cls(stream) if dec_cls is qb3_tpu.Decoder else dec_cls(stream, device=CPU)
        return dec.read_data(partial=True), dec.failed, dec.decode_path
    except Exception as e:  # both must raise alike
        return type(e).__name__, str(e)


@pytest.mark.parametrize("walk", ["native", "python"])
@pytest.mark.parametrize("damage", ["truncated-50", "truncated-90", "garbage", "flip-10",
                                    "flip-37", "flip-64", "flip-91"])
@pytest.mark.parametrize("name", list(DAMAGED))
def test_damaged_stream_decodes_like_qb3_tpu(name, damage, walk, monkeypatch):
    """The same array and `failed` flag as qb3_tpu's read_data(partial=True),
    and an exception where it raises, with the port's walk pinned to its C++
    or its Python walk and qb3_tpu on whichever walk it took (its C++ walk
    where its make-built helper loaded): both walks locate the same groups,
    and a failed walk raises before its end_pos, the one value in which the
    two walks differ, is read.  A flipped BASE stream can walk into
    best-mode group codes (u8-base-h flip-64 meets CF, CF0 or IDX groups):
    the port decodes them as qb3_tpu does."""
    if walk == "python":
        monkeypatch.setattr(native, "available", lambda: False)
    elif not native.available():
        pytest.skip("no C++ compiler: the native walk does not build")
    make, mode = DAMAGED[name]
    stream = _damage(qb3_tpu.encode(make(), mode=mode), damage)
    ours, theirs = _read(qt.Decoder, stream), _read(qb3_tpu.Decoder, stream)
    if not isinstance(ours[0], str):
        assert ours[2] == f"{walk}-walk"
    if (name, damage) == ("u8-base-h", "flip-64"):
        data, info, nblocks = _payload(stream)
        kinds = offsets.parse_offsets(data, nblocks, info.nbands, TYPESIZES[info.dtype],
                                      info.mode)["kind"]
        assert (kinds > offsets.KIND_BITS).any()
    if isinstance(theirs[0], str):
        assert ours[0] == theirs[0]
        return
    np.testing.assert_array_equal(ours[0], theirs[0])
    assert ours[1] == theirs[1]
    assert theirs[2] in ("native-walk", "python-walk")
    if not damage.startswith("flip"):
        assert ours[1] == (damage == "garbage")  # truncated input reads zeros
