"""The CUDA kernels K1 (pack), K2 (chunk walk) and K3 (window copy) of
qb3_tpu_torch against their plain PyTorch twins, on the card.

Every test needs a CUDA device and skips without one.  This file imports
neither jax nor qb3_tpu, so it also runs on a machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import qb3_tpu_torch as qt
from qb3_tpu_torch import container
from qb3_tpu_torch.api import ic_inputs, padded_words, to_carrier
from qb3_tpu_torch.benchutil import headline_image
from qb3_tpu_torch.constants import HILBERT, TYPESIZES, Mode
from qb3_tpu_torch.ops import bitpack, pack_cuda
from qb3_tpu_torch.ops.chunkwalk_cuda import chunkwalk8, chunkwalk8_plain
from qb3_tpu_torch.ops.decode_chunked import decode_chunked, parse_ic
from qb3_tpu_torch.ops.encode import encode_fast_blocks


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


def test_k3_matches_twin(cuda):
    rng = np.random.default_rng(0)
    words = torch.from_numpy(rng.integers(-2**31, 2**31, 3000, dtype=np.int64)
                             .astype(np.int32)).to(cuda)
    wrow = torch.tensor([0, 2, 7, 23, 40], dtype=torch.int32, device=cuda)
    got = pack_cuda.extract_windows(words, wrow, 512)
    assert torch.equal(got, pack_cuda.extract_windows_plain(words, wrow, 512))
    assert torch.equal(got[1], words[256:768])
    assert (got[4] == 0).all()  # past the end: zero slack


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
