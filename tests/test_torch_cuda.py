"""The CUDA kernels K1 (pack), K2 (chunk walk), K3 (window copy), K4 (fused
"ix" walk), K5a / K5b (walks on gathered windows, the best modes' CF, CF0
and IDX groups and the edge inputs of tests/k5_edges.py included), K6
(slab placement, and its stitch entry on the parts of a stitch), K7
(window gather), K8 (fused image-layout VLC + pack), K9 (the fast phase A,
also on the edge inputs of tests/pack_edges.py, and on the batch, pipelined
and one-image encodes with its twin refused), K10 (the best phase A, also
on the edge inputs of tests/best_edges.py and the Landsat sample, and on
the Landsat batch and the one-image best encodes with its twin refused)
and P1-P7 (the Mosaic probes) of
qb3_tpu_torch against their plain PyTorch twins (K1 also at the best modes'
symbol counts), and the public decode (best-mode streams included), the
best modes' phase A, encode, batches and strips and the strips on the card
against the CPU's, the serving paths (the pipelined encode and decode
on CUDA streams, the bulk decode of streams without a sidecar) on the card
against the CPU's, and the sharded encodes and decodes (parallel/sharded.py)
with 2-8 shards on one card against the single-device path and the CPU's
shards, the kernels' launches counted with every twin refused; and
benchutil.sync's wait for the streams of its tensors.

Every test needs a CUDA device and skips without one.  This file imports
neither jax nor qb3_tpu, so it also runs on a machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import base64
import json
import os

import numpy as np
import pytest
import torch

import qb3_tpu_torch as qt
from qb3_tpu_torch import benchutil, container, foreign, pipeline, probes
from qb3_tpu_torch.api import (_fused_ix_params, default_cband, ic_inputs, padded_words,
                               stream_words, to_carrier)
from qb3_tpu_torch.batch import _flat_tile_layout
from qb3_tpu_torch.benchutil import LANDSAT_SAMPLE, device_profile, headline_image
from qb3_tpu_torch.constants import HILBERT, TYPESIZES, ZCURVE, Mode, is_best_mode
from qb3_tpu_torch.ops import bitpack, pack_cuda, probe_cuda
from qb3_tpu_torch.ops.chunkwalk_cuda import chunkwalk8, chunkwalk8_plain
from qb3_tpu_torch.ops.decode import ix_parse, ix_regs, payload_words
from qb3_tpu_torch.ops.decode_chunked import decode_chunked, parse_ic
from qb3_tpu_torch.ops.encode import encode_fast_blocks
from qb3_tpu_torch.ops.encode_cuda import (encode_pack_image, encode_pack_image_plain,
                                           image_pack_args)
from qb3_tpu_torch.ops.encode_image import phase_a_image
from qb3_tpu_torch.ops.fusedwin_cuda import wavefront_fused, wavefront_fused_plain
from qb3_tpu_torch.ops.gather_cuda import (GATHER_MAX_R, gather_slabs, gather_slabs_plain,
                                           gather_span)
from qb3_tpu_torch.ops import phase_a_cuda
from qb3_tpu_torch.ops.encode_best import encode_best_blocks
from qb3_tpu_torch.ops.phase_a_cuda import phase_a_best, phase_a_fast
from qb3_tpu_torch.ops.place_cuda import place_parts, place_slabs, place_slabs_plain
from qb3_tpu_torch.stitch import stitch_words, stitch_words_device
from qb3_tpu_torch.ops.wavefront_cuda import (wavefront8, wavefront8_plain, wavefront_wide,
                                              wavefront_wide_plain)
from qb3_tpu_torch.parallel import sharded

from . import best_edges, k5_edges, p1_cases, pack_edges, walk_edges
from .stitch_cases import STITCH_CASES, stitch_parts

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _walk_inputs(stream, dev):
    """api.ic_inputs of a stream's "ic" sidecar, plus K3's window rows."""
    info = container.parse_headers(stream)
    nblocks = ((info.ysize + 3) // 4) * ((info.xsize + 3) // 4)
    meta = parse_ic(info.index_chunked, nblocks, info.nbands)
    inp = ic_inputs(padded_words(stream[info.data_offset:]), [meta], 0,
                    8 * TYPESIZES[info.dtype], dev)
    return dict(inp, wrow=(inp["starts"][::128] >> 5) >> 7, nblocks=nblocks,
                nb=info.nbands)


@pytest.mark.parametrize("dtype,lead", [
    (np.uint8, ()), (np.uint16, ()), (np.uint32, ()), (np.uint64, ()),
    (np.uint8, (3,)), (np.uint64, (2,))])
def test_k1_matches_twin(cuda, dtype, lead):
    tbits = np.dtype(dtype).itemsize * 8
    imgs = np.stack([headline_image(40, 36, 2, seed=s, dtype=dtype)
                     for s in range(int(np.prod(lead)))]).reshape(*lead, 40, 36, 2)
    zero = torch.zeros(*lead, 2, dtype=torch.int64, device=cuda)
    codes, lens, _, _ = encode_fast_blocks(to_carrier(imgs, cuda), zero, zero,
                                           HILBERT, (0, 1), True, tbits)
    n_words = 2 + (40 * 36 * 2 * (tbits + 2)) // 32 + 64
    maxbits = bitpack.group_bits_bound(tbits, False)
    before = pack_cuda.pack_groups_chunked.launches
    got = pack_cuda.pack_groups_chunked(codes, lens, n_words, maxbits)
    assert pack_cuda.pack_groups_chunked.launches == before + 1
    want = bitpack.pack_groups(codes, lens, n_words, maxbits)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _one_launch(fn, kernel: str):
    """A call's device operations, from the profiler: the kernel once and at
    most one memset."""
    ops = device_profile(fn, 5)["per_op"]
    assert any(kernel in op for op in ops), ops
    assert all(kernel in op or "memset" in op.lower() for op in ops), ops
    assert len(ops) <= 2, ops


@pytest.mark.parametrize("name", list(pack_edges.K1_CASES))
def test_k1_edges_match_twin(cuda, name):
    """K1's block scan, look-back, shared-memory window and stores on the
    inputs that can break them (tests/pack_edges.py), tolerance zero; one
    kernel and at most one memset a call."""
    codes, lens, n_words = pack_edges.k1_case(name)
    codes = torch.from_numpy(codes.view(np.int64)).to(cuda)
    lens = torch.from_numpy(lens).to(cuda)
    for c, ln in ((codes, lens), (codes[0], lens[0])):  # the tile axis, and one tile alone
        before = pack_cuda.pack_groups_chunked.launches
        got = pack_cuda.pack_groups_chunked(c, ln, n_words, 64 * c.shape[-1])
        torch.cuda.synchronize()
        assert pack_cuda.pack_groups_chunked.launches == before + 1
        want = bitpack.pack_groups(c, ln, n_words, 64 * c.shape[-1])
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == w.dtype
            assert torch.equal(g, w)
    if name.endswith("truncated"):
        assert int(got[1]) > 32 * n_words
    _one_launch(lambda: pack_cuda.pack_groups_chunked(codes, lens, n_words, 64),
                "pack_groups_kernel")


def test_k3_matches_twin(cuda):
    rng = np.random.default_rng(0)
    words = torch.from_numpy(rng.integers(-2**31, 2**31, 3000, dtype=np.int64)
                             .astype(np.int32)).to(cuda)
    wrow = torch.tensor([0, 2, 7, 23, 40], dtype=torch.int32, device=cuda)
    got = pack_cuda.extract_windows(words, wrow, 512)
    assert torch.equal(got, pack_cuda.extract_windows_plain(words, wrow, 512))
    assert torch.equal(got[1], words[256:768])
    assert (got[4] == 0).all()  # past the end: zero slack


@pytest.mark.parametrize("n,wrow,R", [
    (3001, [0, 2, 7, 23, 40], 512),    # n not a multiple of 4, ending inside a slice; 40 past it
    (3001, [20, 21, 22, 23, 24], 1024),  # windows across the end and wholly past it
    (4096, [0, 5, 31, 3], 128),        # R = 128: one short slice a window
    (70001, [0, 17, 100, 300, 530, 546], 2176),  # 5 slices a window, the last of 128 words
    (4096, [], 512),                   # no window: no launch
])
def test_k3_edges_match_twin(cuda, n, wrow, R):
    """K3's bulk copies and its threads' path (the slice across the
    stream's end, slices past it) against the twin, tolerance zero."""
    rng = np.random.default_rng(n + R)
    words = torch.from_numpy(rng.integers(-2**31, 2**31, n, dtype=np.int64)
                             .astype(np.int32)).to(cuda)
    wrow = torch.tensor(wrow, dtype=torch.int32, device=cuda)
    before = pack_cuda.extract_windows.launches
    got = pack_cuda.extract_windows(words, wrow, R)
    torch.cuda.synchronize()
    assert pack_cuda.extract_windows.launches == before + (wrow.numel() > 0)
    assert got.shape == (wrow.numel(), R)
    assert torch.equal(got, pack_cuda.extract_windows_plain(words, wrow, R))


@pytest.mark.parametrize("dtype,mode", [
    (np.uint8, Mode.FTL), (np.uint8, Mode.BASE_H), (np.uint16, Mode.FTL),
    (np.uint16, Mode.BASE_Z)])
def test_k2_matches_twin(cuda, dtype, mode):
    img = headline_image(96, 80, 3, seed=5, dtype=dtype)
    img[::8, ::8] = np.iinfo(dtype).max  # high rungs
    stream = qt.encode(img, mode=mode, index="ic", device=cuda)
    a = _walk_inputs(stream, cuda)
    win = pack_cuda.extract_windows(a["words32"], a["wrow"], a["R"])
    ubits = 3 if dtype == np.uint8 else 4
    args = (a["words32"], win, a["wrow"], a["starts"], a["entry"], a["k"], a["nb"],
            mode != Mode.FTL, ubits)
    got = chunkwalk8(*args)
    assert torch.equal(got, chunkwalk8_plain(*args))
    ref = decode_chunked(a["words32"], a["starts"], a["entry"], a["k"], a["nblocks"],
                         a["nb"], mode != Mode.FTL, 8 * np.dtype(dtype).itemsize)
    got = got.reshape(-1, a["nb"], 16)[:a["nblocks"]].reshape(-1, 16).long()
    assert torch.equal(got, ref)


def test_k2_corrupt_stream_matches_twin(cuda):
    """Garbage words and offsets: the kernel keeps the twin's clipped
    register-window semantics, including walks that leave their window."""
    rng = np.random.default_rng(1)
    words32 = torch.from_numpy(rng.integers(-2**31, 2**31, 4096, dtype=np.int64)
                               .astype(np.int32)).to(cuda)
    starts = torch.from_numpy(np.sort(rng.integers(0, 4096 * 32 + 900, 300))
                              .astype(np.int32)).to(cuda)
    entry = torch.from_numpy(rng.integers(0, 256, (300, 2)).astype(np.int32)).to(cuda)
    wrow = (starts[::128] >> 5) >> 7
    win = pack_cuda.extract_windows(words32, wrow, 256)
    for ubits in (3, 4):
        args = (words32, win, wrow, starts, entry, 4, 2, True, ubits)
        assert torch.equal(chunkwalk8(*args), chunkwalk8_plain(*args))


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.uint64])
def test_cuda_roundtrip_equals_cpu(cuda, dtype):
    img = headline_image(60, 52, 3, seed=7, dtype=dtype)
    s_gpu = qt.encode(img, index="ic", device=cuda)
    assert s_gpu == qt.encode(img, index="ic", device="cpu")
    out, _ = qt.decode(s_gpu, device=cuda)
    np.testing.assert_array_equal(out, img)
    tiles = np.stack([headline_image(32, 32, 3, seed=s, dtype=dtype) for s in range(3)])
    streams = qt.encode_tiles(tiles, index="ic", device=cuda)
    assert streams == qt.encode_tiles(tiles, index="ic", device="cpu")
    np.testing.assert_array_equal(qt.decode_tiles(streams, device=cuda), tiles)


def _ix_inputs(tiles, mode, dev):
    """(words32, goff, glens (ntiles, ngroups), per_tile) of a batch of "ix"
    streams in decode_tiles' flat tile layout (one tile: the padded stream)."""
    streams = qt.encode_tiles(tiles, mode=mode, index=True, device="cpu")
    infos = [container.parse_headers(x) for x in streams]
    glens = np.stack([np.frombuffer(i.index, "<u2").astype(np.int64) for i in infos])
    if len(streams) == 1:
        words, tw32 = padded_words(streams[0][infos[0].data_offset:]), 0
    else:
        words, tw32 = _flat_tile_layout([payload_words(x[i.data_offset:])
                                         for x, i in zip(streams, infos)])
    goff = np.cumsum(glens, axis=1) - glens + np.arange(len(streams))[:, None] * tw32 * 32
    words32 = torch.from_numpy(words.reshape(-1).view(np.int32)).to(dev)
    return words32, torch.from_numpy(goff.reshape(-1).astype(np.int32)).to(dev), glens, \
        glens.shape[1]


def _check_k4(words32, goff, nreg, R, tbits, nb, per_tile, apply_step):
    """K4 in both modes against its twin on the same device tensors."""
    before = wavefront_fused.launches
    g, rung = wavefront_fused(words32, goff, nreg, R, tbits, nbands=nb, per_tile=per_tile,
                              apply_step=apply_step)
    torch.cuda.synchronize()
    assert wavefront_fused.launches == before + 1
    want_g, want_rung = wavefront_fused_plain(words32, goff, nreg, tbits, nb,
                                              per_tile=per_tile, apply_step=apply_step)
    assert torch.equal(rung, want_rung) and torch.equal(g, want_g)
    regs = ix_regs(words32, goff, nreg)
    off, rung, kind = (x.to(torch.int32) for x in ix_parse(regs, goff, tbits, nb, per_tile))
    got = wavefront_fused(words32, goff, nreg, R, tbits, off=off, rung=rung, kind=kind,
                          apply_step=apply_step)
    assert torch.equal(got, wavefront_fused_plain(words32, goff, nreg, tbits, off=off,
                                                  rung=rung, kind=kind,
                                                  apply_step=apply_step))


@pytest.mark.parametrize("dtype,mode,shape,ntiles", [
    (np.uint8, Mode.FTL, (256, 256, 3), 1),      # 96 blocks: a long look-back chain
    (np.uint8, Mode.BASE_H, (20, 24, 3), 7),     # 90 groups per tile: resets mid-block
    (np.uint16, Mode.BASE_Z, (64, 48, 8), 3),
    (np.uint32, Mode.FTL, (36, 28, 5), 4),       # 315 groups per tile
    (np.uint64, Mode.BASE_H, (64, 64, 1), 2),
    (np.uint8, Mode.FTL, (8, 8, 130), 3),        # more bands than threads per block
])
def test_k4_matches_twin(cuda, dtype, mode, shape, ntiles):
    tiles = np.stack([headline_image(*shape, seed=20 + s, dtype=dtype) for s in range(ntiles)])
    tiles[:, ::8, ::8] = np.iinfo(dtype).max  # high rungs
    tbits = 8 * np.dtype(dtype).itemsize
    words32, goff, glens, per_tile = _ix_inputs(tiles, mode, cuda)
    nreg, R = _fused_ix_params(glens, tbits, 0)
    _check_k4(words32, goff, nreg, R, tbits, shape[2], per_tile, mode != Mode.FTL)
    _check_k4(words32, goff, nreg, 4, tbits, shape[2], per_tile, False)  # span of 4: stream reads


@pytest.mark.parametrize("tbits", [8, 16, 32, 64])
def test_k4_garbage_matches_twin(cuda, tbits):
    """Random words and group starts, some past either end of the stream:
    JAX's gather clamps and the select chains' defaults, in both modes."""
    rng = np.random.default_rng(tbits)
    words32 = torch.from_numpy(rng.integers(-2**31, 2**31, 3000, dtype=np.int64)
                               .astype(np.int32)).to(cuda)
    goff = np.sort(rng.integers(-4000, 3000 * 32 + 4000, 1050)).astype(np.int32)
    goff = torch.from_numpy(goff).to(cuda)
    for nreg, R in ((4, 64), ({8: 8, 16: 12, 32: 20, 64: 36}[tbits], 1024)):
        _check_k4(words32, goff, nreg, R, tbits, 3, 105, True)


@pytest.mark.parametrize("name", list(walk_edges.K4_CASES))
def test_k4_edges_match_twin(cuda, name):
    """K4's band scan and look-back (tiles that start inside a block, a tile
    of 35 blocks, 1 to 256 bands), its span and stream reads (damaged
    lengths, and a span of 64 words that most windows leave) and every
    element width, both modes, on the inputs of tests/walk_edges.py,
    tolerance zero; a call is one kernel and at most one memset."""
    words32, glens, tbits, nb, nblocks, ntiles, tw32, step = walk_edges.k4_case(name)
    nreg, R = _fused_ix_params(glens.reshape(ntiles, -1), tbits, tw32)
    per_tile = nblocks * nb
    g2 = glens.reshape(ntiles, per_tile).astype(np.int64)
    goff = np.cumsum(g2, 1) - g2 + np.arange(ntiles)[:, None] * tw32 * 32
    words32 = torch.from_numpy(words32).to(cuda)
    goff = torch.from_numpy(goff.reshape(-1).astype(np.int32)).to(cuda)
    for r in (R, 64):
        _check_k4(words32, goff, nreg, r, tbits, nb, per_tile, step)
    _one_launch(lambda: wavefront_fused(words32, goff, nreg, R, tbits, nbands=nb,
                                        per_tile=per_tile), "fused_kernel")


@pytest.mark.parametrize("name", list(walk_edges.K2_CASES))
def test_k2_edges_match_twin(cuda, name):
    """K2 on 1 to 256 bands, u8 and u16, a last tile of fewer than 128
    chunks, and corrupt chunks that start past the stream or outside their
    tile's window (tests/walk_edges.py), against its twin, tolerance zero;
    a call is one kernel."""
    words32, starts, entry, ubits, nb, k, step, maxw, R = walk_edges.k2_case(name)
    words32, starts, entry = (torch.from_numpy(x).to(cuda) for x in (words32, starts, entry))
    wrow = (starts[::128] >> 5) >> 7
    win = pack_cuda.extract_windows(words32, wrow, R)
    args = (words32, win, wrow, starts, entry, k, nb, step, ubits)
    before = chunkwalk8.launches
    got = chunkwalk8(*args)
    torch.cuda.synchronize()
    assert chunkwalk8.launches == before + 1
    assert torch.equal(got, chunkwalk8_plain(*args))
    ops = device_profile(lambda: chunkwalk8(*args), 5)["per_op"]
    assert len(ops) == 1 and "chunkwalk" in next(iter(ops)), ops


@pytest.mark.parametrize("tbits", [8, 16, 32, 64])
def test_k5_matches_twin(cuda, tbits):
    """Valid windows from an "ix" stream, then garbage over the domain."""
    dtype = {8: np.uint8, 16: np.uint16, 32: np.uint32, 64: np.uint64}[tbits]
    tiles = headline_image(64, 40, 2, seed=9, dtype=dtype)[None]
    tiles[:, ::8, ::8] = np.iinfo(dtype).max
    words32, goff, glens, per_tile = _ix_inputs(tiles, Mode.FTL, cuda)
    nreg, _ = _fused_ix_params(glens, tbits)
    regs = ix_regs(words32, goff, nreg)
    off, rung, kind = ix_parse(regs, goff, tbits, 2, per_tile)
    rng = np.random.default_rng(tbits)
    n = 5000
    garbage = (rng.integers(-2**31, 2**31, (n, nreg), dtype=np.int64).astype(np.int32),
               rng.integers(0, 64, n), rng.integers(0, tbits, n), rng.integers(0, 3, n))
    for args in ((regs[:, :nreg], off, rung, kind),
                 tuple(torch.from_numpy(x) for x in garbage)):
        args = tuple(x.to(cuda, torch.int32).contiguous() for x in args) + (nreg,)
        if tbits == 8:
            got, want = wavefront8(*args), wavefront8_plain(*args)
        else:
            got, want = wavefront_wide(*args, tbits), wavefront_wide_plain(*args, tbits)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.parametrize("name", list(k5_edges.CASES))
def test_k5_edges_match_twin(cuda, name):
    """K5a / K5b on the edge inputs of tests/k5_edges.py (every bit phase,
    top rungs and u64 long forms past NREG, codes past NREG, nreg 1-36,
    partial last blocks, IDX max indices 0-7, kinds outside 0-5, with and
    without cf), from an aligned tensor and from a view one row in (rows
    4-byte aligned where nreg is odd), against the twins, tolerance zero;
    a call is one launch of one kernel."""
    regs, off, rung, kind, nreg, tbits, cf = k5_edges.k5_case(name)
    padded = torch.from_numpy(np.concatenate([np.zeros((1, nreg), np.int32), regs])).to(cuda)
    args = tuple(torch.from_numpy(x).to(cuda) for x in (off, rung, kind)) + (nreg,)
    args = args + ((tbits,) if tbits > 8 else ())
    cf = None if cf is None else torch.from_numpy(cf).to(cuda)
    kern, plain = (wavefront8, wavefront8_plain) if tbits == 8 else (wavefront_wide,
                                                                     wavefront_wide_plain)
    want = plain(padded[1:], *args, cf)
    for r in (padded[1:].clone(), padded[1:]):
        before = kern.launches
        got = kern(r, *args, cf)
        torch.cuda.synchronize()
        assert kern.launches == before + 1
        assert torch.equal(got, want)
    ops = device_profile(lambda: kern(padded[1:], *args, cf), 5)["per_op"]
    assert len(ops) == 1 and "wavefront" in next(iter(ops)), ops


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.uint64])
def test_cuda_ix_roundtrip_equals_cpu(cuda, dtype):
    img = headline_image(60, 52, 3, seed=8, dtype=dtype)
    s_gpu = qt.encode(img, index=True, device=cuda)
    assert s_gpu == qt.encode(img, index=True, device="cpu")
    dec = qt.Decoder(s_gpu, device=cuda)
    np.testing.assert_array_equal(dec.read_data(), img)
    assert dec.decode_path == "ix"
    tiles = np.stack([headline_image(32, 36, 3, seed=s, dtype=dtype) for s in range(3)])
    streams = qt.encode_tiles(tiles, index=True, device=cuda)
    assert streams == qt.encode_tiles(tiles, index=True, device="cpu")
    np.testing.assert_array_equal(qt.decode_tiles(streams, device=cuda), tiles)


def _full_range_u64(shape, seed):
    """Full-range u64 noise: blocks at rung 63, the 65-bit long code."""
    return np.random.default_rng(seed).integers(0, 1 << 64, shape, dtype=np.uint64)


@pytest.mark.parametrize("dtype,shape,order,cband,skipstep", [
    (np.uint16, (64, 96, 1), HILBERT, (0,), True),
    (np.uint16, (20, 36, 3), HILBERT, (1, 1, 1), False),   # W/4 * C = 27 groups a row
    (np.uint32, (32, 48, 4), ZCURVE, (1, 1, 1, 3), False),
    (np.uint64, (48, 64, 1), ZCURVE, (0,), True),
    (np.uint64, (16, 32, 2), HILBERT, (0, 1), False),      # full range: rung 63
])
def test_k8_matches_twin(cuda, dtype, shape, order, cband, skipstep):
    if dtype == np.uint64 and not skipstep:
        img = _full_range_u64(shape, seed=31)
    else:
        img = headline_image(*shape, seed=30, dtype=dtype)
        img[::8, ::8] = np.iinfo(dtype).max  # high rungs beside the grain's low ones
    h, w, nb = shape
    tbits = 8 * np.dtype(dtype).itemsize
    rng = np.random.default_rng(32)
    prev = rng.integers(0, 1 << min(tbits, 63), nb, dtype=np.uint64).astype(dtype)
    runbits = torch.from_numpy(rng.integers(0, tbits // 2, nb).astype(np.int32)).to(cuda)
    o = phase_a_image(to_carrier(img, cuda), to_carrier(prev, cuda), runbits, order, cband,
                      skipstep, tbits)
    args = image_pack_args(o, tbits, stream_words(w, h, nb, {16: 2, 32: 4, 64: 6}[tbits]), order)
    before = encode_pack_image.launches
    got = encode_pack_image(*args)
    torch.cuda.synchronize()
    assert encode_pack_image.launches == before + 1
    want = encode_pack_image_plain(*args)
    for g, x in zip(got, want):
        assert torch.equal(g, x)
    if not skipstep and dtype == np.uint64:
        assert int(o["rung"].max()) == 63


@pytest.mark.parametrize("name", list(pack_edges.K8_CASES))
def test_k8_edges_match_twin(cuda, name):
    """K8's staged row segments, block scan, look-back, window and stores at
    1, 3, 8, 13 and 200 bands, one group, a block of zero-length groups,
    block edges at every bit phase, truncation and 65-bit codes, tolerance
    zero; one kernel and at most one memset a call."""
    img = pack_edges.k8_image(name)
    h, w, nb = img.shape
    tbits = 8 * img.itemsize
    o = phase_a_image(to_carrier(img, cuda), torch.zeros(nb, dtype=torch.int64, device=cuda),
                      torch.zeros(nb, dtype=torch.int32, device=cuda), HILBERT,
                      tuple(default_cband(nb)), tbits == 64, tbits)
    args = list(image_pack_args(o, tbits, stream_words(w, h, nb, {16: 2, 32: 4, 64: 6}[tbits]),
                                HILBERT))
    fields = [args[i].cpu().numpy() for i in (2, 3, 4, 5)]  # gkind, pcode, plen, glen
    pack_edges.k8_edit(name, *fields)
    args[2:6] = [torch.from_numpy(f).to(cuda) for f in fields]
    args[7] = pack_edges.k8_n_words(name, fields[3], args[7])
    before = encode_pack_image.launches
    got = encode_pack_image(*args)
    torch.cuda.synchronize()
    assert encode_pack_image.launches == before + 1
    want = encode_pack_image_plain(*args)
    for g, x in zip(got, want):
        assert g.shape == x.shape and g.dtype == x.dtype
        assert torch.equal(g, x)
    if name == "truncated":
        assert int(got[1]) > 32 * args[7]
    if name == "u64-65-bit":
        assert int(o["rung"].max()) == 63
    _one_launch(lambda: encode_pack_image(*args), "encode_pack_image_kernel")


@pytest.mark.parametrize("dtype,mode", [(np.uint16, Mode.FTL), (np.uint32, Mode.BASE_Z),
                                        (np.uint64, Mode.BASE_H)])
def test_public_wide_encode_goes_through_k8(cuda, monkeypatch, dtype, mode):
    """The public encode of a wide image on the card: the block encode's
    bytes (phase A + K1), through K8 and not K1."""
    img = headline_image(64, 52, 3, seed=33, dtype=dtype)
    with monkeypatch.context() as m:
        m.setattr(qt.api, "takes_fused", lambda *shape: False)
        want = {index: qt.encode(img, mode=mode, index=index, device=cuda)
                for index in (False, True, "ic")}
    k1, k8 = pack_cuda.pack_groups_chunked.launches, encode_pack_image.launches
    for index, stream in want.items():
        assert qt.encode(img, mode=mode, index=index, device=cuda) == stream
        np.testing.assert_array_equal(qt.decode(stream, device=cuda)[0], img)
    assert encode_pack_image.launches == k8 + 3
    assert pack_cuda.pack_groups_chunked.launches == k1


# ------------------------------------------------ K9 (ops/phase_a_cuda.py)

# name -> (dtype, lead + (H, W, C), curve, cband, skipstep, entry state):
# every width, 1, 3, 4 and 16 bands with default and other core bands,
# aligned and unaligned sides, both curves, FTL and BASE, zero and non-zero
# entry state, no leading axis, (1,) and (128,)
K9_CARD = {
    "u8 512x512x3 x128 ftl": (np.uint8, (128, 512, 512, 3), HILBERT, (1, 1, 1), True, "zero"),
    "u8 512x512x3 base": (np.uint8, (512, 512, 3), HILBERT, (1, 1, 1), False, "random"),
    "u8 4x4x1 (1,) z base": (np.uint8, (1, 4, 4, 1), ZCURVE, (0,), False, "random"),
    "u8 513x517x16": (np.uint8, (513, 517, 16), HILBERT, tuple(range(16)), True, "random"),
    "u8 5x7x3 x128": (np.uint8, (128, 5, 7, 3), HILBERT, (1, 1, 1), True, "random"),
    "u16 5x7x3 z base": (np.uint16, (5, 7, 3), ZCURVE, (2, 1, 2), False, "random"),
    "u16 513x517x4 (1,)": (np.uint16, (1, 513, 517, 4), HILBERT, (1, 1, 1, 3), True, "random"),
    "u16 512x512x1 x128 base": (np.uint16, (128, 512, 512, 1), HILBERT, (0,), False, "zero"),
    "u32 4x4x16 base": (np.uint32, (4, 4, 16), HILBERT, (5,) * 16, False, "random"),
    "u32 512x512x4 z": (np.uint32, (512, 512, 4), ZCURVE, (0, 0, 2, 2), True, "random"),
    "u32 5x7x1 x128 z base": (np.uint32, (128, 5, 7, 1), ZCURVE, (0,), False, "random"),
    "u64 513x517x3 base": (np.uint64, (513, 517, 3), HILBERT, (1, 1, 1), False, "random"),
    "u64 512x512x1 z": (np.uint64, (512, 512, 1), ZCURVE, (0,), True, "zero"),
    "u64 5x7x4 (1,) base": (np.uint64, (1, 5, 7, 4), HILBERT, (1, 1, 1, 3), False, "random"),
}


def _k9_state(lead, nb, tbits, kind, seed, dev):
    """entry_prev (int64 carrier) and entry_runbits (int32) of shape lead +
    (nb,): zero, or random values and rungs."""
    if kind == "zero":
        z = torch.zeros(*lead, nb, dtype=torch.int64, device=dev)
        return z, z
    rng = np.random.default_rng(seed)
    prev = rng.integers(0, 1 << 64, (*lead, nb), dtype=np.uint64, endpoint=False)
    prev = prev & np.uint64((1 << tbits) - 1) if tbits < 64 else prev
    runbits = rng.integers(0, tbits, (*lead, nb)).astype(np.int32)
    return (torch.from_numpy(prev.view(np.int64)).to(dev),
            torch.from_numpy(runbits).to(dev))


def _k9_equal(img, prev, runbits, order, cband, skipstep, tbits):
    """K9 (one launch, the kernel alone on the device) against its twin on
    the same card tensors, every output, tolerance zero."""
    for with_rungs in (True, False):
        before = phase_a_fast.launches
        got = phase_a_fast(img, prev, runbits, order, cband, skipstep, tbits, with_rungs)
        torch.cuda.synchronize()
        assert phase_a_fast.launches == before + 1
        want = encode_fast_blocks(img, prev, runbits, order, cband, skipstep, tbits, with_rungs)
        assert len(got) == len(want)
        for name, g, w in zip(("codes", "lens", "exit_prev", "exit_runbits", "rung"), got, want):
            assert g.shape == w.shape and g.dtype == w.dtype and g.is_cuda, name
            assert torch.equal(g, w), name
    ops = device_profile(lambda: phase_a_fast(img, prev, runbits, order, cband, skipstep,
                                              tbits, True), 3)["per_op"]
    assert list(ops) and all("phase_a_kernel" in op for op in ops), ops


@pytest.mark.parametrize("name", list(K9_CARD))
def test_k9_matches_twin(cuda, name):
    dtype, shape, order, cband, skipstep, state = K9_CARD[name]
    *lead, h, w, nb = shape
    tbits = 8 * np.dtype(dtype).itemsize
    n = int(np.prod(lead))
    if dtype == np.uint64 and not skipstep:
        img = _full_range_u64((n, h, w, nb), seed=900)  # rung 63, the 65th bit
    else:
        img = np.stack([headline_image(h, w, nb, seed=900 + i, dtype=dtype) for i in range(n)])
        img[:, ::8, ::8] = np.iinfo(dtype).max  # high rungs beside the grain's low ones
    x = to_carrier(img.reshape(*lead, h, w, nb), cuda)
    prev, runbits = _k9_state(lead, nb, tbits, state, 901, cuda)
    _k9_equal(x, prev, runbits, order, cband, skipstep, tbits)


@pytest.mark.parametrize("skipstep", [True, False], ids=["ftl", "base"])
@pytest.mark.parametrize("name", list(pack_edges.K9_CASES))
def test_k9_edges_match_twin(cuda, name, skipstep):
    """K9 on the edge inputs of tests/pack_edges.py (all-zero groups,
    bitsused 1, 1*0* step patterns of every length at low and high rungs,
    u64 rung-63 groups with the 65th bit, values at each type's maximum),
    from a zero and a random entry state, against its twin."""
    img, order = pack_edges.k9_case(name)
    nb = img.shape[-1]
    tbits = 8 * img.itemsize
    x = to_carrier(img, cuda)
    for state in ("zero", "random"):
        prev, runbits = _k9_state((), nb, tbits, state, 902, cuda)
        _k9_equal(x, prev, runbits, order, tuple(range(nb)), skipstep, tbits)


def _refuse_k9_twin(monkeypatch):
    def refuse(*_, **__):
        raise AssertionError("K9's twin ran on the card's path")

    monkeypatch.setattr(phase_a_cuda, "encode_fast_blocks", refuse)


@pytest.mark.parametrize("dtype,mode,index", [(np.uint8, Mode.FTL, "ic"),
                                              (np.uint8, Mode.BASE_H, True),
                                              (np.uint8, Mode.BASE_Z, False),
                                              (np.uint16, Mode.FTL, "ic")])
def test_batch_and_pipelined_encodes_go_through_k9(cuda, monkeypatch, dtype, mode, index):
    """batch.encode_tiles and the pipelined encode on the card, K9's twin
    refused: the CPU's streams (the headline tile's to its sha256), one K9
    launch a batch."""
    import hashlib

    tiles = np.stack([headline_image(dtype=dtype)]
                     + [headline_image(seed=3000 + i, dtype=dtype) for i in range(5)])
    batches = [tiles, tiles[::-1], tiles[1:4]]
    want = qt.encode_tiles(tiles, mode=mode, index=index, device="cpu")
    want_piped = list(pipeline.encode_tiles_pipelined(iter(batches), mode=mode, index=index,
                                                      device="cpu"))
    if dtype == np.uint8 and mode == Mode.FTL:
        assert hashlib.sha256(want[0]).hexdigest() == benchutil.HEADLINE_SHA256
        assert want_piped[0] == want
    _refuse_k9_twin(monkeypatch)
    before = phase_a_fast.launches
    assert qt.encode_tiles(tiles, mode=mode, index=index, device=cuda) == want
    assert phase_a_fast.launches == before + 1
    got = list(pipeline.encode_tiles_pipelined(iter(batches), mode=mode, index=index,
                                               device=cuda))
    assert phase_a_fast.launches == before + 4
    assert got == want_piped


def test_one_image_encodes_go_through_k9(cuda, monkeypatch):
    """The one-image encode of a u8 tile (its stream to the headline sha256)
    and of a u16 raster whose sides are not multiples of 4 (not K8's) take
    K9 once each, with its twin refused, and write the CPU's bytes."""
    import hashlib

    img8, img16 = headline_image(), headline_image(513, 517, 2, seed=903, dtype=np.uint16)
    want = [qt.encode(img8, index="ic", device="cpu"),
            qt.encode(img16, mode=Mode.BASE_H, index=True, device="cpu")]
    _refuse_k9_twin(monkeypatch)
    before = phase_a_fast.launches
    got = [qt.encode(img8, index="ic", device=cuda),
           qt.encode(img16, mode=Mode.BASE_H, index=True, device=cuda)]
    assert phase_a_fast.launches == before + 2
    assert got == want
    assert hashlib.sha256(got[0]).hexdigest() == benchutil.HEADLINE_SHA256

# ------------------------------------------------ K10 (ops/phase_a_cuda.py)

# name -> (dtype, lead + (H, W, C), curve, cband, entry state): every width,
# 1, 3, 5, 8 and 16 bands with default and other core bands, aligned and
# unaligned sides, both curves (CF_H's Hilbert, CF's Z), zero and non-zero
# entry state, no leading axis, (1,), (3,) and a Landsat pass of 8
K10_CARD = {
    "u8 24x32x5 kinds": (np.uint8, (24, 32, 5), HILBERT, (1, 1, 3, 3, 4), "zero"),
    "u8 513x517x16": (np.uint8, (513, 517, 16), HILBERT, tuple(range(16)), "random"),
    "u8 5x7x3 (3,) z": (np.uint8, (3, 5, 7, 3), ZCURVE, (1, 1, 1), "random"),
    "u16 24x32x5 kinds z": (np.uint16, (24, 32, 5), ZCURVE, (0, 0, 2, 2, 4), "random"),
    "u16 21x18x1 (1,)": (np.uint16, (1, 21, 18, 1), HILBERT, (0,), "random"),
    "u16 512x512x8 x8": (np.uint16, (8, 512, 512, 8), HILBERT, (0, 1, 2, 3, 4, 5, 6, 7), "zero"),
    "u32 24x32x5 kinds": (np.uint32, (24, 32, 5), HILBERT, (1, 1, 3, 3, 4), "random"),
    "u32 13x9x3 z": (np.uint32, (13, 9, 3), ZCURVE, (2, 2, 2), "random"),
    "u64 24x32x5 kinds z": (np.uint64, (24, 32, 5), ZCURVE, (1, 1, 3, 3, 4), "random"),
    "u64 1024x1024x1": (np.uint64, (1024, 1024, 1), HILBERT, (0,), "zero"),
    "u64 9x13x8 (1,)": (np.uint64, (1, 9, 13, 8), HILBERT, (1, 1, 1, 1, 1, 1, 1, 1), "random"),
}


def _k10_state(lead, nb, tbits, kind, seed, dev):
    """entry_prev, entry_runbits (int32) and entry_cf of shape lead + (nb,)
    on dev: zero, or random values, rungs and biased CFs."""
    prev, runbits = _k9_state(lead, nb, tbits, kind, seed, dev)
    if kind == "zero":
        return prev, runbits, prev
    rng = np.random.default_rng(seed + 1)
    cf = rng.integers(0, 1 << min(tbits - 2, 20), (*lead, nb)).astype(np.int64)
    return prev, runbits, torch.from_numpy(cf).to(dev)


def _k10_raster(dtype, shape, seed):
    """kinds_scene rasters where the name says so (every group kind), else
    the headline grain with whole groups at the type's top and common factors
    in a quarter."""
    *lead, h, w, nb = shape
    n = int(np.prod(lead))
    if h == 24 and w == 32:
        return best_edges.kinds_scene(h, w, nb, dtype, seed)
    if dtype == np.uint64 and h >= 512:
        img = _full_range_u64((n, h, w, nb), seed=seed) >> np.uint64(20)
    else:
        img = np.stack([headline_image(h, w, nb, seed=seed + i, dtype=dtype) for i in range(n)])
    img[:, ::8, ::8] = np.iinfo(dtype).max
    img[:, : h // 2, : w // 2] = img[:, : h // 2, : w // 2] // 6 * 6
    return img.reshape(*lead, h, w, nb)


def _k10_equal(img, prev, runbits, cf, order, cband, tbits):
    """K10 (one launch, its memset and kernel alone on the device) against
    its twin on the same card tensors, all nine outputs, tolerance zero."""
    before = phase_a_best.launches
    got = phase_a_best(img, prev, runbits, cf, order, cband, tbits)
    torch.cuda.synchronize()
    assert phase_a_best.launches == before + 1
    want = encode_best_blocks(img, prev, runbits, cf, order, cband, tbits)
    assert len(got) == len(want) == 9
    for name, g, w in zip(("codes", "lens", "exit_prev", "exit_runbits", "exit_cf", "meta16",
                           "cfv", "post_runbits", "pcf_in"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype and g.is_cuda, name
        assert torch.equal(g, w), name
    ops = device_profile(lambda: phase_a_best(img, prev, runbits, cf, order, cband, tbits),
                         3)["per_op"]
    assert any("phase_a_best_kernel" in op for op in ops), ops
    assert all("phase_a_best_kernel" in op or "memset" in op.lower() for op in ops), ops


@pytest.mark.parametrize("name", list(K10_CARD))
def test_k10_matches_twin(cuda, name):
    dtype, shape, order, cband, state = K10_CARD[name]
    *lead, h, w, nb = shape
    tbits = 8 * np.dtype(dtype).itemsize
    x = to_carrier(_k10_raster(dtype, shape, 910), cuda)
    _k10_equal(x, *_k10_state(lead, nb, tbits, state, 911, cuda), order, cband, tbits)


@pytest.mark.parametrize("name", list(best_edges.K10_CASES))
def test_k10_edges_match_twin(cuda, name):
    """K10 on the edge inputs of tests/best_edges.py (all values equal, tied
    counts, 9 uniques, a CF of 2 and more at every rung, CFs at and past
    2^16, the u64 magnitude 2^63, rung 63), alone and as 2 tiles, from a
    zero and a random entry state, against its twin."""
    img, order, cband = best_edges.k10_case(name)
    nb, tbits = img.shape[-1], 8 * img.itemsize
    for x in (to_carrier(img, cuda), to_carrier(np.stack([img, img[::-1]]), cuda)):
        lead = tuple(x.shape[:-3])
        for state in ("zero", "random"):
            _k10_equal(x, *_k10_state(lead, nb, tbits, state, 912, cuda), order, cband, tbits)


def test_k10_landsat_sample_matches_twin(cuda):
    """The Landsat sample's tile (CF_H, its own core bands) through K10 and
    its twin; its re-encode on the card gives the pinned stream."""
    import hashlib

    with open(os.path.join(ROOT, LANDSAT_SAMPLE), "rb") as f:
        sample = f.read()
    info = container.parse_headers(sample)
    raster = qt.decode(sample, device="cpu")[0]
    z = torch.zeros(info.nbands, dtype=torch.int64, device=cuda)
    _k10_equal(to_carrier(raster, cuda), z, z, z, HILBERT, tuple(info.cband), 16)
    stream = qt.encode(raster, mode=info.mode, coreband=info.cband, device=cuda)
    assert hashlib.sha256(stream).hexdigest() == benchutil.LANDSAT_ENCODE_SHA256


def _refuse_k10_twin(monkeypatch):
    def refuse(*_, **__):
        raise AssertionError("K10's twin ran on the card's path")

    monkeypatch.setattr(phase_a_cuda, "encode_best_blocks", refuse)


def test_landsat_batch_goes_through_k10(cuda, monkeypatch):
    """batch.encode_tiles in CF_H on 24 Landsat-shaped tiles (the sample,
    flipped and turned), K10's twin refused: one K10 launch a pass of
    batch.BEST_GROUPS groups (3 passes of 8), the twin's streams (the twin
    on the card), the sample's to its pin."""
    import hashlib

    from qb3_tpu_torch import batch

    with open(os.path.join(ROOT, LANDSAT_SAMPLE), "rb") as f:
        sample = f.read()
    info = container.parse_headers(sample)
    land = qt.decode(sample, device="cpu")[0]
    views = [land, land[::-1], land[:, ::-1], np.rot90(land), np.rot90(land, 2), np.rot90(land, 3)]
    tiles = np.ascontiguousarray(np.stack([views[i % 6] for i in range(24)]))
    passes = -(-24 // (batch.BEST_GROUPS // (128 * 128 * 8)))
    with monkeypatch.context() as m:
        m.setattr(batch, "phase_a_best", encode_best_blocks)
        want = qt.encode_tiles(tiles, mode=Mode.CF_H, coreband=info.cband, device=cuda)
    _refuse_k10_twin(monkeypatch)
    before = phase_a_best.launches
    got = qt.encode_tiles(tiles, mode=Mode.CF_H, coreband=info.cband, device=cuda)
    assert passes == 3 and phase_a_best.launches == before + passes
    assert got == want
    assert hashlib.sha256(got[0]).hexdigest() == benchutil.LANDSAT_ENCODE_SHA256


def test_batch_copies_are_staged_and_match_the_cpu(cuda):
    """batch.encode_tiles on the card copies through page-locked buffers:
    Landsat CF_H batches of 24, 1, 9, 17 and 24 tiles (flips, turns and
    shifts of the sample, as the benchmark builds them) and a u8 FTL "ic"
    batch, back to back from one host buffer rewritten between calls, so
    that a staging buffer reused while its copy is in flight would show,
    give the CPU's streams; each batch counts a staged upload a pass (3 for
    24 Landsat tiles) and two staged fetch rounds."""
    from qb3_tpu_torch import batch, profiling

    with open(os.path.join(ROOT, LANDSAT_SAMPLE), "rb") as f:
        sample = f.read()
    info = container.parse_headers(sample)
    land = qt.decode(sample, device="cpu")[0]
    rng = np.random.default_rng(2801)
    pool = [land]
    for k in rng.permutation(8)[:7]:
        x = np.rot90(land, k % 4, (0, 1))
        x = x[::-1] if k >= 4 else x
        pool.append(np.roll(x, tuple(4 * int(v) for v in rng.integers(0, 128, 2)), (0, 1)))
    pool = np.ascontiguousarray(np.stack(pool))
    want = qt.encode_tiles(pool, mode=Mode.CF_H, coreband=info.cband, device="cpu")
    per = batch.BEST_GROUPS // (128 * 128 * 8)
    buf = np.empty((24, *land.shape), land.dtype)
    for n in (24, 1, 9, 17, 24):
        idx = rng.integers(0, len(pool), n)
        np.copyto(buf[:n], pool[idx])
        before = profiling.counters()
        got = qt.encode_tiles(buf[:n], mode=Mode.CF_H, coreband=info.cband, device=cuda)
        after = profiling.counters()
        assert got == [want[i] for i in idx]
        assert after["batch.staged_uploads"] - before["batch.staged_uploads"] == -(-n // per)
        assert after["batch.staged_fetches"] - before["batch.staged_fetches"] == 2
    assert per == 8
    tiles = [headline_image(64, 64, 3, seed=s) for s in range(12)]
    u8 = np.empty((6, 64, 64, 3), np.uint8)
    for b in (tiles[:6], tiles[6:]):
        np.copyto(u8, np.stack(b))
        before = profiling.counters()
        got = qt.encode_tiles(u8, index="ic", device=cuda)
        after = profiling.counters()
        assert got == qt.encode_tiles(np.stack(b), index="ic", device="cpu")
        assert after["batch.staged_uploads"] - before["batch.staged_uploads"] == 1
        assert after["batch.staged_fetches"] - before["batch.staged_fetches"] == 2


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.uint64])
def test_one_image_best_encodes_go_through_k10(cuda, monkeypatch, dtype):
    """The one-image best encodes (CF_H and CF, no sidecar, "ib", "ic"; a
    best strip) take K10 once a call with its twin refused and write the
    CPU's bytes; the u8 headline's to its pins."""
    import hashlib

    img = _best_raster(dtype)
    if dtype == np.uint8:
        img = headline_image()
    cases = ((Mode.CF_H, False), (Mode.CF_H, True), (Mode.CF_H, "ic"), (Mode.CF, True))
    want = [qt.encode(img, mode=mode, index=index, device="cpu") for mode, index in cases]
    _refuse_k10_twin(monkeypatch)
    before = phase_a_best.launches
    got = [qt.encode(img, mode=mode, index=index, device=cuda) for mode, index in cases]
    assert phase_a_best.launches == before + len(cases)
    assert got == want
    if dtype == np.uint8:
        assert hashlib.sha256(got[1]).hexdigest() == benchutil.BEST_HEADLINE_SHA256["ib"]
        assert hashlib.sha256(got[2]).hexdigest() == benchutil.BEST_HEADLINE_SHA256["ic"]
    h, w, c = img.shape
    se = qt.StripEncoder(w, h, c, qt.api.DT_FROM_NP[img.dtype], mode=Mode.CF_H,
                         strip_rows=h // 2, device=cuda)
    se.push(img[: h // 2])  # a whole strip, then the rest at the flush
    se.push(img[h // 2:])
    assert se.finish() == want[0]
    assert phase_a_best.launches == before + len(cases) + 2


def test_k7_matches_twin(cuda):
    """The windows of a walked stream, then garbage offsets: unsorted,
    negative and past the end, with the host span, the smallest span (every
    word from the stream) and the largest."""
    img = headline_image(64, 60, 3, seed=40, dtype=np.uint16)
    stream = qt.encode(img, device="cpu")
    info = container.parse_headers(stream)
    data = stream[info.data_offset:]
    meta, _ = qt.api.walk_offsets(data, 16 * 15, 3, 2, info.mode)
    inp = qt.api.walk_inputs(meta, padded_words(data), 16, cuda)
    rng = np.random.default_rng(41)
    n32 = inp["words32"].shape[0]
    garbage = torch.from_numpy(rng.integers(-50, n32 + 50, 3000).astype(np.int32)).to(cuda)
    for base, W, R in ((inp["base"], inp["nreg"], inp["R"]), (inp["base"], 12, 4),
                       (garbage, 36, gather_span(garbage.cpu().numpy(), 36)),
                       (garbage, 5, GATHER_MAX_R)):
        before = gather_slabs.launches
        got = gather_slabs(inp["words32"], base, W, R)
        torch.cuda.synchronize()
        assert gather_slabs.launches == before + 1
        assert torch.equal(got, gather_slabs_plain(inp["words32"], base, W))


@pytest.mark.parametrize("case", ["sorted", "garbage", "over-the-cap", "none"])
@pytest.mark.parametrize("W", [5, 8, 12, 20, 36])
def test_k7_edges_match_twin(cuda, W, case):
    """K7 at every window width the decode uses and one that is not a
    multiple of 4, against the twin, tolerance zero: 1000 sorted bases (not
    a multiple of 128 groups; the last ones past the stream's end), 777
    unsorted ones, negative and past the end, bases whose blocks span more
    than GATHER_MAX_R words, and no group (no launch)."""
    rng = np.random.default_rng(W)
    n32 = 40003
    words = torch.from_numpy(rng.integers(-2**31, 2**31, n32, dtype=np.int64)
                             .astype(np.int32)).to(cuda)
    base = {"sorted": np.sort(rng.integers(n32 - 9000, n32 + 10, 1000)),
            "garbage": rng.integers(-60, n32 + 60, 777),
            "over-the-cap": np.arange(300) * 100,
            "none": np.zeros(0)}[case].astype(np.int32)
    R = gather_span(base, W)
    if case == "over-the-cap":
        assert R == GATHER_MAX_R
    before = gather_slabs.launches
    got = gather_slabs(words, torch.from_numpy(base).to(cuda), W, R)
    torch.cuda.synchronize()
    assert gather_slabs.launches == before + (base.size > 0)
    assert got.shape == (base.size, W)
    assert torch.equal(got, gather_slabs_plain(words, torch.from_numpy(base).to(cuda), W))


@pytest.mark.parametrize("dtype,mode", [
    (np.uint8, Mode.FTL), (np.uint8, Mode.RLE_H), (np.uint16, Mode.BASE_Z),
    (np.uint32, Mode.FTL), (np.uint64, Mode.BASE_H)])
def test_cuda_walk_decode_equals_cpu(cuda, dtype, mode):
    """Streams without a sidecar: the serial walk, K7 and K5 on the card
    decode to the CPU's array (the twins)."""
    img = headline_image(60, 52, 3, seed=42, dtype=dtype)
    img[8:40, 4:44] = 0  # a no-data area: zero runs for the RLE form
    img[::8, ::8] = np.iinfo(dtype).max  # high rungs
    stream = qt.encode(img, mode=mode, device=cuda)
    assert stream == qt.encode(img, mode=mode, device="cpu")
    assert container.parse_headers(stream).mode == mode
    k7, k5 = gather_slabs.launches, wavefront8.launches + wavefront_wide.launches
    dec = qt.Decoder(stream, device=cuda)
    out = dec.read_data()
    assert dec.decode_path == "native-walk"
    assert gather_slabs.launches == k7 + 1
    assert wavefront8.launches + wavefront_wide.launches == k5 + 1
    np.testing.assert_array_equal(out, qt.decode(stream, device="cpu")[0])
    np.testing.assert_array_equal(out, img)


def test_k6_matches_twin(cuda):
    """K6 against its twin: sorted disjoint-bit slabs (a stitch's), the same
    slabs unsorted, words dropped past n_words, and random values (the sum
    wraps alike)."""
    rng = np.random.default_rng(43)
    totals = [int(t) for t in rng.integers(0, 40000, 9)] + [0, 31, 64, 1]
    words = [torch.from_numpy(rng.integers(-2**31, 2**31, -(-t // 32) + 2, dtype=np.int64)
                              .astype(np.int32)) for t in totals]
    n_out = -(-sum(totals) // 32)
    want, _ = stitch_words_device(words, totals, n_out)
    before = place_slabs.launches + place_parts.launches
    got, _ = stitch_words_device([w.to(cuda) for w in words], totals, n_out)
    torch.cuda.synchronize()
    assert place_slabs.launches + place_parts.launches == before + 1
    assert torch.equal(got.cpu(), want)
    slab = torch.from_numpy(rng.integers(-2**31, 2**31, (5000, 7), dtype=np.int64)
                            .astype(np.int32)).to(cuda)
    base = torch.from_numpy(rng.integers(0, 30000, 5000).astype(np.int32)).to(cuda)
    for b in (torch.sort(base).values, base):
        for n_words in (30010, 20000):
            got = place_slabs(slab, b, n_words)
            torch.cuda.synchronize()
            assert torch.equal(got, place_slabs_plain(slab, b, n_words))


def _stitch_on_card(parts, totals, n_out):
    """stitch_words_device on the card -> (words on the host, total), with
    K6's launches checked: one of the stitch entry a stitch, none for an
    empty output, none of the slab entry."""
    before = place_slabs.launches, place_parts.launches
    got, total = stitch_words_device(parts, totals, n_out)
    torch.cuda.synchronize()
    assert (place_slabs.launches, place_parts.launches) == (before[0], before[1] + (n_out > 0))
    return got.cpu(), total


@pytest.mark.parametrize("name", list(STITCH_CASES))
def test_k6_stitch_entry_matches_twin(cuda, name):
    """K6's stitch entry against its twin (the CPU route: stitch_slabs, then
    place_slabs_plain) and the host stitch_words, the parts as rows of one
    tensor and as tensors trimmed to their totals, at n_out short of, equal
    to and past the total's words."""
    totals = [int(t) for t in STITCH_CASES[name]]
    words = stitch_parts(totals, seed=len(name))
    w32 = torch.from_numpy(words.view(np.int32))
    total = sum(totals)
    host, _ = stitch_words([(w, n) for w, n in zip(words, totals)])
    host = torch.from_numpy(host.view(np.int32))
    trimmed = [w32[s, : -(-n // 32)].clone().to(cuda) for s, n in enumerate(totals)]
    n = -(-total // 32)
    for n_out in (max(0, n - 2), n, n + 40):
        want, _ = stitch_words_device(w32, totals, n_out)
        m = min(n_out, host.shape[0])
        assert torch.equal(want[:m], host[:m]) and not want[m:].any()
        for parts in (w32.to(cuda), trimmed):
            got, gtotal = _stitch_on_card(parts, totals, n_out)
            assert gtotal == total and got.dtype == torch.int32
            assert torch.equal(got, want)


@pytest.mark.parametrize("seed", range(8))
def test_k6_stitch_entry_random_rows(cuda, seed):
    """K6's stitch entry on 2-64 random parts, row views of one (S, NW)
    tensor on the card (as the 2-D mesh passes them), against its twin and
    the host stitch_words."""
    rng = np.random.default_rng(200 + seed)
    S, NW = int(rng.integers(2, 65)), int(rng.integers(1, 600))
    totals = rng.integers(0, 32 * NW + 1, S)
    totals[rng.random(S) < 0.2] = 0
    totals[rng.random(S) < 0.2] %= 40  # parts under 32 bits, several on one word
    totals = [int(t) for t in totals]
    words = rng.integers(0, 1 << 32, (S, NW), dtype=np.uint64).astype(np.uint32)
    w32 = torch.from_numpy(words.view(np.int32))
    n_out = -(-sum(totals) // 32)
    want, _ = stitch_words_device(w32, totals, n_out)
    host, _ = stitch_words([(w, n) for w, n in zip(words, totals)])
    assert torch.equal(want, torch.from_numpy(host.view(np.int32)[:n_out]))
    rows = w32.to(cuda)
    got, _ = _stitch_on_card([rows[s] for s in range(S)], totals, n_out)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype,mode,index", [(np.uint8, Mode.FTL, False),
                                              (np.uint16, Mode.BASE_H, True),
                                              (np.uint8, Mode.RLE_H, "ic")])
def test_cuda_strips_equal_cpu(cuda, dtype, mode, index):
    """StripEncoder on the card: the CPU's bytes and the whole-image encode,
    stitched by K6 once; StripDecoder on the card: the image, with K7 and K5
    launched for every strip."""
    img = headline_image(200, 64, 3, seed=44, dtype=dtype)
    img[40:120, 8:56] = 0
    h, w, c = img.shape

    def strips(device):
        se = qt.StripEncoder(w, h, c, qt.api.DT_FROM_NP[img.dtype], mode=mode,
                             strip_rows=32, with_index=index, device=device)
        for y in range(0, h, 24):
            se.push(img[y:y + 24])
        return se.finish()

    k6 = place_slabs.launches + place_parts.launches
    stream = strips(cuda)
    assert place_slabs.launches + place_parts.launches == k6 + 1
    assert stream == strips("cpu") == qt.encode(img, mode=mode, index=index, device=cuda)
    k7 = gather_slabs.launches
    sd = qt.StripDecoder(stream, strip_rows=32, device=cuda)
    rows = []
    while (r := sd.read(50)) is not None:
        rows.append(r)
    assert sd.decode_path == "native-walk"
    assert gather_slabs.launches == k7 + -(-h // 32)
    np.testing.assert_array_equal(np.concatenate(rows), img)


@pytest.mark.parametrize("with_cf", [True, False])
@pytest.mark.parametrize("tbits", [8, 16, 32, 64])
def test_k5_best_kinds_match_twin(cuda, tbits, with_cf):
    """Random windows, offsets, rungs and common factors over every kind, the
    best modes' CF (3), CF0 (4) and IDX (5) included; without cf (the
    decode passes None where no group is CF or CF0) CF groups read 0."""
    rng = np.random.default_rng(100 + tbits)
    n, nreg = 6000, {8: 8, 16: 12, 32: 20, 64: 36}[tbits]
    args = tuple(torch.from_numpy(x.astype(np.int32)).to(cuda) for x in (
        rng.integers(-2**31, 2**31, (n, nreg), dtype=np.int64), rng.integers(0, 64, n),
        rng.integers(0, tbits, n), rng.integers(0, 6, n))) + (nreg,)
    cf = torch.from_numpy(rng.integers(0, 1 << 64, n, dtype=np.uint64).view(np.int64)).to(cuda)
    cf = cf if with_cf else None
    before = wavefront8.launches + wavefront_wide.launches
    if tbits == 8:
        got, want = wavefront8(*args, cf), wavefront8_plain(*args, cf)
    else:
        got, want = wavefront_wide(*args, tbits, cf), wavefront_wide_plain(*args, tbits, cf)
    torch.cuda.synchronize()
    assert wavefront8.launches + wavefront_wide.launches == before + 1
    assert torch.equal(got, want)


def _best_streams():
    """The best-mode web fixtures and the Landsat sample: name -> stream."""
    with open(os.path.join(ROOT, "web", "test", "fixtures.js")) as f:
        text = f.read()
    out = {c["name"]: base64.b64decode(c["stream"])
           for c in json.loads(text[text.index("["): text.rindex("]") + 1])}
    out = {k: v for k, v in out.items() if is_best_mode(container.parse_headers(v).mode)}
    with open(os.path.join(ROOT, LANDSAT_SAMPLE), "rb") as f:
        out["landsat"] = f.read()
    return out


def test_cuda_best_decode_equals_cpu(cuda):
    """Best-mode streams without a sidecar: the C++ walk, then K7 and K5 on
    the card, decode to the CPU's arrays (the twins)."""
    streams = _best_streams()
    assert len(streams) == 4
    for name, stream in streams.items():
        k7, k5 = gather_slabs.launches, wavefront8.launches + wavefront_wide.launches
        dec = qt.Decoder(stream, device=cuda)
        out = dec.read_data()
        assert dec.decode_path == "native-walk", name
        assert gather_slabs.launches == k7 + 1 and \
            wavefront8.launches + wavefront_wide.launches == k5 + 1, name
        np.testing.assert_array_equal(out, qt.decode(stream, device="cpu")[0], err_msg=name)


def _best_raster(dtype, h=24, w=32, c=3, seed=45):
    """Grain with common factors (of u16 range for the wide types), a
    few-valued area (index groups) and a flat one."""
    narrow = np.uint16 if np.dtype(dtype).itemsize > 2 else dtype
    img = headline_image(h, w, c, seed=seed, dtype=narrow).astype(dtype) // 3 * 3
    step = min(np.iinfo(dtype).max // 37, 1000)  # factors within the sidecars' 16 bits
    rng = np.random.default_rng(seed)
    img[: h // 2, : w // 2] = (np.array([0, 1, 3, 7]) * step + 11).astype(dtype)[
        rng.integers(0, 4, (h // 2, w // 2, c))]
    img[h // 2:, w // 2:] = 5
    return img


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.uint32, np.uint64])
def test_encode_best_blocks_cuda_equals_cpu(cuda, dtype):
    """The best modes' phase A on the card: all nine outputs equal its run
    on the CPU."""
    from qb3_tpu_torch.ops.encode_best import encode_best_blocks

    img = _best_raster(dtype, 20, 28)
    outs = []
    for dev in (cuda, torch.device("cpu")):
        zero = torch.zeros(3, dtype=torch.int64, device=dev)
        outs.append(encode_best_blocks(to_carrier(img, dev), zero, zero, zero, HILBERT,
                                       (1, 1, 1), 8 * img.itemsize))
    for i, (g, w) in enumerate(zip(*outs)):
        assert torch.equal(g.cpu(), w), i


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.uint64])
def test_cuda_best_paths_equal_cpu(cuda, dtype):
    """The best encode (phase A + K1) on the card gives the CPU's bytes with
    no sidecar, "ib" and "ic"; the decodes ("ic-best" walk, "ib": K7 + K5)
    give the raster; the batch and the strips give the CPU's bytes."""
    img = _best_raster(dtype)
    for mode, index in ((Mode.CF_H, False), (Mode.CF_RLE_H, True), (Mode.CF_H, "ic"),
                        (Mode.CF, True)):
        k1 = pack_cuda.pack_groups_chunked.launches
        stream = qt.encode(img, mode=mode, index=index, device=cuda)
        assert pack_cuda.pack_groups_chunked.launches == k1 + 1
        assert stream == qt.encode(img, mode=mode, index=index, device="cpu")
        dec = qt.Decoder(stream, device=cuda)
        np.testing.assert_array_equal(dec.read_data(), img)
        info = container.parse_headers(stream)
        assert dec.decode_path == ("ib" if info.index_best else "ic-best"
                                   if info.index_chunked else "native-walk")
        assert (info.index_best or info.index_chunked) if index else True
    tiles = np.stack([_best_raster(dtype, seed=s) for s in (46, 47, 48)])
    streams = qt.encode_tiles(tiles, mode=Mode.CF_H, index=True, device=cuda)
    assert streams == qt.encode_tiles(tiles, mode=Mode.CF_H, index=True, device="cpu")
    np.testing.assert_array_equal(qt.decode_tiles(streams, device=cuda), tiles)
    h, w, c = img.shape
    se = qt.StripEncoder(w, h, c, qt.api.DT_FROM_NP[img.dtype], mode=Mode.CF_H, strip_rows=8,
                         with_index=True, device=cuda)
    se.push(img)
    stream = se.finish()
    assert stream == qt.encode(img, mode=Mode.CF_H, index=True, device="cpu")
    sd = qt.StripDecoder(stream, strip_rows=8, device=cuda)
    rows = []
    while (r := sd.read(8)) is not None:
        rows.append(r)
    np.testing.assert_array_equal(np.concatenate(rows), img)


@pytest.mark.parametrize("name", list(probes.PROBES))
def test_probe_kernels_match_twins(cuda, name):
    """P1-P7 at their probes' shapes against their twins, then the probe on
    the card passes its own check."""
    kernel, plain = probes.KERNELS[name]
    args = probes.probe_inputs(name, cuda)
    before = kernel.launches
    got = kernel(*args)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert torch.equal(got.cpu(), plain(*(a.cpu() if torch.is_tensor(a) else a for a in args)))
    assert probes.PROBES[name](cuda)


def _p1_check(got, a, b, integer: bool):
    """P1's output against its twin on the CPU: equal on integer-valued
    inputs, within p1_cases.tolerance on random ones."""
    want = probe_cuda.dim0_dot_plain(torch.from_numpy(a).to(torch.bfloat16),
                                     torch.from_numpy(b).to(torch.bfloat16))
    assert got.dtype == torch.float32 and got.shape == want.shape
    if integer:
        assert torch.equal(got.cpu(), want)
    else:
        err = (got.cpu().double() - want.double()).abs().numpy()
        bound = p1_cases.tolerance(a, b)
        assert (err <= bound).all(), float((err / bound).max())


@pytest.mark.parametrize("integer", [True, False], ids=["integer", "random"])
@pytest.mark.parametrize("shape", p1_cases.SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_p1_matches_twin(cuda, shape, integer):
    """P1 on the tensor cores at ragged, multi-CTA and long shapes: one
    launch a call, equal to its twin on integer-valued inputs and within
    2^-16 of the sum of |a_km b_kn| on random bf16 ones."""
    a, b = p1_cases.inputs(shape, integer)
    before = probe_cuda.dim0_dot.launches
    got = probe_cuda.dim0_dot(*(torch.from_numpy(x).to(torch.bfloat16).to(cuda) for x in (a, b)))
    torch.cuda.synchronize()
    assert probe_cuda.dim0_dot.launches == before + 1
    _p1_check(got, a, b, integer)


def test_p1_reads_unaligned_rows(cuda):
    """Bases that are not 16-byte aligned (views one element into their
    storage), with M and N multiples of 8: the threads read the rows."""
    a, b = p1_cases.inputs((40, 64, 24), True)
    views = []
    for x in (a, b):
        flat = torch.zeros(x.size + 1, dtype=torch.bfloat16, device=cuda)
        flat[1:] = torch.from_numpy(x.reshape(-1)).to(torch.bfloat16).to(cuda)
        views.append(flat[1:].view(x.shape))
    assert all(v.data_ptr() % 16 for v in views)
    _p1_check(probe_cuda.dim0_dot(*views), a, b, True)


def test_p1_refuses_what_its_kernel_does_not_take(cuda):
    a = torch.ones(16, 8, dtype=torch.bfloat16, device=cuda)
    b = torch.ones(16, 24, dtype=torch.bfloat16, device=cuda)
    for args, err in (((a.float(), b), TypeError), ((a, b.half()), TypeError),
                      ((a.T.contiguous().T, b), ValueError), ((a, b[:, ::2]), ValueError),
                      ((a[None], b), ValueError), ((a, b[:8]), ValueError),
                      ((a, b.cpu()), ValueError)):
        before = probe_cuda.dim0_dot.launches
        with pytest.raises(err):
            probe_cuda.dim0_dot(*args)
        assert probe_cuda.dim0_dot.launches == before


def _pipeline_batches(seed, n=3, nbatches=3):
    return [np.stack([headline_image(64, 64, 3, seed=seed + 10 * b + i) for i in range(n)])
            for b in range(nbatches)]


@pytest.mark.parametrize("index", [False, True, "ic"], ids=["none", "ix", "ic"])
@pytest.mark.parametrize("mode", [Mode.FTL, Mode.BASE_Z])
def test_cuda_pipeline_equals_cpu(cuda, mode, index):
    """The pipelined encode on the card's streams writes the CPU's bytes,
    and the pipelined decode returns the tiles."""
    batches = _pipeline_batches(seed=int(mode))
    before = pack_cuda.pack_groups_chunked.launches
    got = list(pipeline.encode_tiles_pipelined(iter(batches), mode=mode, index=index,
                                               device=cuda))
    assert pack_cuda.pack_groups_chunked.launches == before + 3
    assert got == list(pipeline.encode_tiles_pipelined(iter(batches), mode=mode, index=index,
                                                       device="cpu"))
    if index:
        for d, b in zip(pipeline.decode_tiles_pipelined(iter(got), device=cuda), batches):
            np.testing.assert_array_equal(d, b)


def test_cuda_pipeline_fetch_cap_fallback(cuda):
    """A noisy third batch passes the cap learned from a smooth first one."""
    rng = np.random.default_rng(3)
    smooth = np.zeros((2, 64, 64, 1), np.uint8)
    noisy = (rng.integers(0, 2, (2, 64, 64, 1)) * 120
             + rng.integers(0, 60, (2, 64, 64, 1))).astype(np.uint8)
    batches = [smooth, smooth, noisy]
    got = list(pipeline.encode_tiles_pipelined(iter(batches), index="ic", device=cuda))
    assert got == list(pipeline.encode_tiles_pipelined(iter(batches), index="ic",
                                                       device="cpu"))


def test_cuda_pipeline_ib_decode_equals_cpu(cuda):
    batches = _pipeline_batches(seed=500, n=2)
    streams = [qt.encode_tiles(b, mode=Mode.CF_H, index=True, device=cuda) for b in batches]
    for d, c, b in zip(pipeline.decode_tiles_pipelined(iter(streams), device=cuda),
                       pipeline.decode_tiles_pipelined(iter(streams), device="cpu"), batches):
        np.testing.assert_array_equal(d, c)
        np.testing.assert_array_equal(d, b)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("mode", [Mode.FTL, Mode.RLE_H, Mode.CF_H])
def test_cuda_foreign_decode_equals_cpu(cuda, mode, dtype):
    """Streams without a sidecar, walked in a thread pool, decoded by K7 and
    K5 on the card: the CPU's arrays, one batch and pipelined."""
    tiles = [headline_image(64, 64, 3, seed=600 + i, dtype=dtype) for i in range(4)]
    streams = [qt.encode(t, mode=mode, device=cuda) for t in tiles]
    t, np_dt = foreign.decode_streams(streams, device=cuda)
    assert t.is_cuda
    np.testing.assert_array_equal(t.cpu().numpy().view(np_dt), np.stack(tiles))
    c, _ = foreign.decode_streams(streams, workers=1, device="cpu")
    np.testing.assert_array_equal(t.cpu().numpy(), c.numpy())
    batches = [streams[:2], streams[2:], streams[1:3]]
    for d, b in zip(foreign.decode_streams_pipelined(iter(batches), device=cuda),
                    ([tiles[0], tiles[1]], [tiles[2], tiles[3]], [tiles[1], tiles[2]])):
        np.testing.assert_array_equal(d, np.stack(b))


# ------------------------------------------------ sharded (parallel/sharded.py)

_TWINS = (("wavefront_cuda", "wavefront8_plain"), ("wavefront_cuda", "wavefront_wide_plain"),
          ("gather_cuda", "gather_slabs_plain"), ("pack_cuda", "pack_groups"),
          ("pack_cuda", "extract_windows_plain"), ("chunkwalk_cuda", "chunkwalk8_plain"),
          ("fusedwin_cuda", "wavefront_fused_plain"), ("encode_cuda", "encode_pack_image_plain"),
          ("place_cuda", "place_slabs_plain"), ("phase_a_cuda", "encode_fast_blocks"))
# "K6": the stitch entry, which every device stitch launches; "K6 slabs":
# the slab entry, which no path launches
_SHARD_KERNELS = {"K1": pack_cuda.pack_groups_chunked, "K2": chunkwalk8,
                  "K3": pack_cuda.extract_windows, "K5a": wavefront8, "K5b": wavefront_wide,
                  "K6": place_parts, "K6 slabs": place_slabs, "K7": gather_slabs}


class no_twins:
    """Within the block, every kernel's plain twin raises: the path inside
    runs on the kernels alone."""

    def __enter__(self):
        import importlib

        def refuse(*_, **__):
            raise AssertionError("a twin ran on the card's path")

        self.saved = [(m, n, getattr(m, n)) for m, n in (
            (importlib.import_module(f"qb3_tpu_torch.ops.{mod}"), name) for mod, name in _TWINS)]
        for m, n, _ in self.saved:
            setattr(m, n, refuse)

    def __exit__(self, *exc):
        for m, n, fn in self.saved:
            setattr(m, n, fn)


def _launches():
    return {k: fn.launches for k, fn in _SHARD_KERNELS.items()}


def _ran(before):
    return {k for k, n in _launches().items() if n > before[k]}


_SHARD_IMAGES = {"u8 64x96x3": lambda: headline_image(64, 96, 3, seed=700),
                 "u16 256x128x1": lambda: headline_image(256, 128, 1, seed=701,
                                                         dtype=np.uint16)}


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("label", list(_SHARD_IMAGES))
@pytest.mark.parametrize("mode,index", [(Mode.FTL, "ic"), (Mode.FTL, True),
                                        (Mode.BASE_H, False), (Mode.CF_H, True),
                                        (Mode.RLE_H, False)],
                         ids=["ftl-ic", "ftl-ix", "base-h", "cf-h-ib", "rle-h"])
def test_cuda_sharded_encode_equals_single_and_cpu(cuda, n, label, mode, index):
    """encode_sharded with n shards on one card: the bytes of the port's
    single-device encode on the card and of the CPU's shards; K1 a shard
    (the best modes also K6), and the sharded decode of the sidecar streams
    back to the raster (K3 + K2 or K7 + K5), with every twin refused."""
    img = _SHARD_IMAGES[label]()
    before = _launches()
    with no_twins():
        s = sharded.encode_sharded(img, n, mode=mode, index=index, devices=["cuda:0"] * n)
    want = {"K1", "K6"} if is_best_mode(mode) else {"K1"}
    assert _ran(before) == want
    assert s == qt.encode(img, mode=mode, index=index, device=cuda)
    assert s == sharded.encode_sharded(img, n, mode=mode, index=index, devices=["cpu"] * n)
    if index:
        before = _launches()
        with no_twins():
            out = sharded.decode_fast_sharded(s, n, devices=["cuda:0"] * n)
        np.testing.assert_array_equal(out, img)
        np.testing.assert_array_equal(out, sharded.decode_fast_sharded(s, n,
                                                                       devices=["cpu"] * n))
        wide = "K5a" if img.itemsize == 1 else "K5b"
        assert _ran(before) == ({"K3", "K2"} if index == "ic" else {"K7", wide})


@pytest.mark.parametrize("n", [2, 4, 8])
def test_cuda_sharded_fast_and_scatter_equal_cpu(cuda, n):
    img = headline_image(128, 64, 3, seed=710)
    with no_twins():
        got = sharded.encode_fast_sharded(img, n, cband=(1, 1, 1), devices=["cuda:0"] * n)
        sc = sharded.encode_fast_sharded_scatter(img, n, cband=(1, 1, 1),
                                                 devices=["cuda:0"] * n)
    cpu = sharded.encode_fast_sharded(img, n, cband=(1, 1, 1), devices=["cpu"] * n)
    assert got[0] == sc[0] == cpu[0]
    np.testing.assert_array_equal(got[1], cpu[1])


@pytest.mark.parametrize("dtype", [np.uint32, np.uint64])
def test_cuda_sharded_wide_types(cuda, dtype):
    """u32 / u64: the sharded "ix" and "ib" decodes (K7 + K5b) and the "ic"
    decode (the plain chunk walk, as in qb3_tpu) on the card."""
    img = headline_image(64, 64, 1, seed=720, dtype=dtype)
    for mode, index in ((Mode.FTL, True), (Mode.FTL, "ic"), (Mode.CF_H, True)):
        with no_twins():
            s = sharded.encode_sharded(img, 4, mode=mode, index=index, devices=["cuda:0"] * 4)
            out = sharded.decode_fast_sharded(s, 4, devices=["cuda:0"] * 4)
        assert s == qt.encode(img, mode=mode, index=index, device=cuda)
        np.testing.assert_array_equal(out, img)


def test_cuda_sharded_2d_mesh(cuda):
    tiles = np.stack([headline_image(32, 64, 3, seed=730 + i) for i in range(8)])
    before = _launches()
    with no_twins():
        got = sharded.encode_tiles_sharded(tiles, 2, 2, devices=["cuda:0"] * 4)
    assert _ran(before) == {"K1", "K6"}
    assert got == sharded.encode_tiles_sharded(tiles, 2, 2, devices=["cpu"] * 4)
    for t, p in zip(tiles, got):
        s = qt.encode(t, coreband=[0, 1, 2], device=cuda)
        assert p == s[container.parse_headers(s).data_offset:]


def test_cuda_stitch_streams_and_dryrun(cuda):
    rng = np.random.default_rng(740)
    words = rng.integers(0, 1 << 32, (4, 8), dtype=np.uint64).astype(np.uint32)
    totals = np.array([3, 0, 256, 77], np.int64)
    before = _launches()
    with no_twins():
        got, _ = sharded.stitch_streams(words, totals, devices=["cuda:0"] * 4)
    assert _ran(before) == {"K6"}
    assert got == sharded.stitch_streams(words, totals, devices=["cpu"] * 4)[0]
    sharded.dryrun_multichip(4, ["cuda:0"] * 4)
    sharded.dryrun_multichip(8, ["cuda:0"] * 8)


def test_sync_waits_for_a_second_stream(cuda):
    """benchutil.sync waits for the stream a tensor was written on, not the
    current stream alone; a tree of host leaves returns without waiting."""
    side = torch.cuda.Stream()

    def queue(cycles):
        done = torch.cuda.Event()
        with torch.cuda.stream(side):
            torch.cuda._sleep(cycles)
            done.record()
            return done, torch.ones(4, device=cuda)

    queue(1)  # loads the ops' kernels first: a lazy load waits for the whole card
    torch.cuda.synchronize()
    done, x = queue(100_000_000)  # ~50 ms
    benchutil.sync((b"xy", np.zeros(3), [7]))
    assert not done.query()
    benchutil.sync({"out": [x], "host": b"xy"})
    assert done.query()
