"""K2's and K3's plain twins (qb3_tpu_torch.ops.chunkwalk_cuda,
qb3_tpu_torch.ops.pack_cuda), the PyTorch chunk walk and reconstruct
against qb3_tpu, on the CPU.

Streams come from qb3_tpu.encode; the JAX side runs its portable XLA walk
(decode_chunked) and, in one case each, its Pallas kernels in interpret
mode.  The tolerance is zero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qb3_tpu
from qb3_tpu import container
from qb3_tpu.constants import HILBERT, ZCURVE, Mode
from qb3_tpu.ops import decode as jdecode
from qb3_tpu.ops import decode_chunked as jdc
from qb3_tpu_torch.ops import decode as tdecode
from qb3_tpu_torch.ops import decode_chunked as tdc
from qb3_tpu_torch.ops import pack_cuda
from qb3_tpu_torch.ops.chunkwalk_cuda import chunkwalk8, ic_walk_params

from . import corpus

j_decode_chunked = jax.jit(jdc.decode_chunked, static_argnums=(3, 4, 5, 6, 7))
j_reconstruct = jax.jit(jdecode.reconstruct, static_argnums=(2, 3, 4, 5, 6, 7))
j_reconstruct_batch = jax.jit(jdecode.reconstruct_batch, static_argnums=(1, 2, 3, 4, 5, 6))


def _ic_inputs(img, mode):
    stream = qb3_tpu.encode(img, mode=mode, index="ic")
    info = container.parse_headers(stream)
    nb = info.nbands
    nblocks = ((info.ysize + 3) // 4) * ((info.xsize + 3) // 4)
    k, starts, entry, total = jdc.parse_ic(info.index_chunked, nblocks, nb)
    words = jdecode.payload_words(stream[info.data_offset:])
    n_words = 1 << max(4, int(np.ceil(np.log2(len(words)))))
    wpad = np.zeros(n_words, np.uint64)
    wpad[: len(words)] = words
    return wpad, starts, entry, total, k, nblocks, nb


def _jax_walk(wpad, starts, entry, k, nblocks, nb, apply_step, tbits):
    return np.asarray(j_decode_chunked(
        jnp.asarray(wpad.view(np.uint32)), jnp.asarray(starts.astype(np.int32)),
        jnp.asarray(entry), k, nblocks, nb, apply_step, tbits)).astype(np.uint64)


def _spiky(img):
    img = img.copy()
    top = np.iinfo(img.dtype).max
    img[::8, ::8] = top  # 0 <-> max spikes plant the widest codes
    img[4::8, 2::8] = 0
    return img


WALK_CASES = {
    "u8-ftl": (lambda: corpus.natural8(64, 48, 2, seed=90), Mode.FTL),
    "u8-base-z-high-rungs": (lambda: _spiky(corpus.natural8(48, 64, 1, seed=91)),
                             Mode.BASE_Z),
    "u16-ftl": (lambda: corpus.to_type(corpus.natural8(48, 64, 1, seed=92),
                                       np.uint16, 257), Mode.FTL),
    "u16-base-high-rungs": (lambda: _spiky(corpus.to_type(
        corpus.natural8(48, 64, 1, seed=94), np.uint16, 300)), Mode.BASE_H),
}


@pytest.mark.parametrize("name", list(WALK_CASES))
def test_k2_twin_matches_xla_walk(name):
    make, mode = WALK_CASES[name]
    img = make()
    tbits = img.dtype.itemsize * 8
    wpad, starts, entry, total, k, nblocks, nb = _ic_inputs(img, mode)
    ref = _jax_walk(wpad, starts, entry, k, nblocks, nb, mode != Mode.FTL, tbits)
    # the port's u8/u16 dispatch: K3 windows, then K2 (twins on the CPU)
    maxw, R = ic_walk_params(starts, np.diff(np.append(starts, total)))
    got = tdc.decode_chunked_auto(
        torch.from_numpy(wpad.view(np.int32)), torch.from_numpy(starts.astype(np.int32)),
        torch.from_numpy(entry), k, nblocks, nb, mode != Mode.FTL, tbits, maxw, R)
    np.testing.assert_array_equal(got.numpy().view(np.uint64), ref)


@pytest.mark.parametrize("dtype,mult,mode", [
    (np.uint32, 65537, Mode.FTL), (np.uint64, 1 << 40, Mode.BASE_H)])
def test_wide_walk_matches_xla_walk(dtype, mult, mode):
    img = corpus.to_type(corpus.natural8(32, 28, 1, seed=95), dtype, mult)
    img[0, 0, 0] = np.iinfo(dtype).max
    tbits = img.dtype.itemsize * 8
    wpad, starts, entry, _, k, nblocks, nb = _ic_inputs(img, mode)
    ref = _jax_walk(wpad, starts, entry, k, nblocks, nb, mode != Mode.FTL, tbits)
    got = tdc.decode_chunked(torch.from_numpy(wpad.view(np.int32)),
                             torch.from_numpy(starts.astype(np.int32)),
                             torch.from_numpy(entry), k, nblocks, nb, mode != Mode.FTL, tbits)
    np.testing.assert_array_equal(got.numpy().view(np.uint64), ref)


@pytest.mark.parametrize("tbits", [8, 16])
def test_k2_twin_matches_xla_walk_on_garbage(tbits):
    """Random words and offsets: clipped register windows, walks past the
    tile windows and the stream end all follow the JAX walk."""
    rng = np.random.default_rng(tbits)
    wpad = rng.integers(0, 1 << 63, 1024, dtype=np.int64).astype(np.uint64)
    starts = np.sort(rng.integers(0, 1024 * 64 + 500, 200)).astype(np.int64)
    entry = rng.integers(0, 256, (200, 2)).astype(np.int32)
    ref = _jax_walk(wpad, starts, entry, 4, 800, 2, True, tbits)
    got = tdc.decode_chunked_auto(
        torch.from_numpy(wpad.view(np.int32)), torch.from_numpy(starts.astype(np.int32)),
        torch.from_numpy(entry), 4, 800, 2, True, tbits, 16, 256)
    np.testing.assert_array_equal(got.numpy().view(np.uint64), ref)


def test_k2_twin_matches_pallas_kernel_interpret():
    from qb3_tpu.ops.chunkwalk_pallas import chunkwalk8 as j_chunkwalk8
    from qb3_tpu.ops.chunkwalk_pallas import ic_maxw, ic_window_R

    img = corpus.natural8(48, 40, 3, seed=96)
    wpad, starts, entry, total, k, nblocks, nb = _ic_inputs(img, Mode.BASE_H)
    maxw = ic_maxw(np.diff(np.append(starts, total)))
    ref = np.asarray(j_chunkwalk8(
        jnp.asarray(wpad), jnp.asarray(starts.astype(np.int32)), jnp.asarray(entry),
        maxw, k, nb, True, G_BLK=128, interpret=True, R=ic_window_R(starts, maxw)))
    assert (maxw, ic_window_R(starts, maxw)) == ic_walk_params(
        starts, np.diff(np.append(starts, total)))
    words32 = torch.from_numpy(wpad.view(np.int32))
    st = torch.from_numpy(starts.astype(np.int32))
    wrow = (st[::128] >> 5) >> 7
    win = pack_cuda.extract_windows(words32, wrow, ic_window_R(starts, maxw))
    before = chunkwalk8.launches
    got = chunkwalk8(words32, win, wrow, st, torch.from_numpy(entry), k, nb, True, 3)
    assert chunkwalk8.launches == before  # CPU: the twin
    np.testing.assert_array_equal(got.numpy().view(np.uint32), ref)


def test_k3_twin_matches_pallas_kernel_interpret():
    from qb3_tpu.ops.pack_pallas import extract_windows as j_extract

    rng = np.random.default_rng(0)
    words = rng.integers(0, 1 << 32, 2000, dtype=np.int64).astype(np.uint32)
    wrow = np.array([0, 2, 7, 13, 15], np.int32)  # the last runs past the end
    ref = np.asarray(j_extract(jnp.asarray(words), jnp.asarray(wrow), 512, interpret=True))
    got = pack_cuda.extract_windows(torch.from_numpy(words.view(np.int32)),
                                    torch.from_numpy(wrow), 512)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), ref)


RECON_CASES = [  # (tbits, h, w, nb, order, cband)
    (8, 32, 24, 3, HILBERT, (1, 1, 1)), (8, 21, 18, 2, ZCURVE, (0, 1)),
    (16, 16, 20, 1, HILBERT, (0,)), (32, 13, 9, 2, HILBERT, (1, 1)),
    (64, 24, 16, 2, ZCURVE, (0, 0)), (64, 7, 5, 1, HILBERT, (0,)),
]


def _groups(tbits, h, w, nb, seed, lead=()):
    rng = np.random.default_rng(seed)
    nblocks = ((h + 3) // 4) * ((w + 3) // 4)
    hi = 1 << min(tbits, 63)
    g = rng.integers(0, hi, (*lead, nblocks, nb, 16), dtype=np.uint64)
    if tbits == 64:
        g |= rng.integers(0, 2, g.shape, dtype=np.uint64) << np.uint64(63)
    return g


@pytest.mark.parametrize("tbits,h,w,nb,order,cband", RECON_CASES)
def test_reconstruct_matches(tbits, h, w, nb, order, cband):
    out_dtype = np.dtype(f"uint{tbits}").type
    g = _groups(tbits, h, w, nb, seed=tbits + h)
    prev = _groups(tbits, 4, 4, nb, seed=1)[0, :, 0].astype(out_dtype)
    jimg, jexit = j_reconstruct(jnp.asarray(g), jnp.asarray(prev), h, w, nb,
                                      order, cband, out_dtype)
    timg, texit = tdecode.reconstruct(torch.from_numpy(g.view(np.int64)),
                                      torch.from_numpy(prev.astype(np.uint64).view(np.int64)),
                                      h, w, nb, order, cband, tbits)
    np.testing.assert_array_equal(timg.numpy().view(np.uint64), np.asarray(jimg).astype(np.uint64))
    # JAX keeps the u32 running sum for types under 32 bits; its low tbits
    # are the band state
    np.testing.assert_array_equal(texit.numpy().view(np.uint64),
                                  np.asarray(jexit).astype(out_dtype).astype(np.uint64))


@pytest.mark.parametrize("tbits", [8, 64])
def test_reconstruct_batch_matches(tbits):
    out_dtype = np.dtype(f"uint{tbits}").type
    g = _groups(tbits, 16, 12, 3, seed=5, lead=(3,))
    ref = j_reconstruct_batch(jnp.asarray(g), 16, 12, 3, HILBERT, (1, 1, 1), out_dtype)
    got = tdecode.reconstruct_batch(torch.from_numpy(g.view(np.int64)), 16, 12, 3, HILBERT,
                                    (1, 1, 1), tbits)
    np.testing.assert_array_equal(got.numpy().view(np.uint64), np.asarray(ref).astype(np.uint64))
