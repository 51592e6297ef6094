"""The "ix" sidecar path of qb3_tpu_torch against qb3_tpu, on the CPU: K4's
plain twin (ops/fusedwin_cuda) against the TPU kernel wavefront_fused run in
interpret mode, decode_indexed_narrow against the JAX package's XLA walk,
the "ix" encode's bytes, and the public decode of valid and damaged streams,
one image and a batch.  Inputs are made with numpy from a seed; the
tolerance is zero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qb3_tpu
import qb3_tpu_torch as qt
from qb3_tpu import container
from qb3_tpu.batch import decode_tiles as j_decode_tiles
from qb3_tpu.batch import encode_tiles as j_encode_tiles
from qb3_tpu.constants import Mode
from qb3_tpu.ops import decode as jdecode
from qb3_tpu.ops.fusedwin_pallas import fused_params, pick_g_blk
from qb3_tpu.ops.fusedwin_pallas import wavefront_fused as j_wavefront_fused
from qb3_tpu_torch import native
from qb3_tpu_torch.api import _fused_ix_params, _indexed_nreg
from qb3_tpu_torch.benchutil import headline_image
from qb3_tpu_torch.ops import decode as tdecode
from qb3_tpu_torch.ops.fusedwin_cuda import wavefront_fused

from . import corpus
from .test_torch_api import CORPUS
from .test_torch_wavefront import _spiky, ix_stream_inputs

j_decode_indexed = jax.jit(jdecode.decode_indexed_narrow, static_argnums=(2, 3, 4, 5, 6),
                           static_argnames=("nreg", "ntiles", "tile_words32"))


def _goff(glens):
    return (np.cumsum(glens.astype(np.int64)) - glens).astype(np.int32)


def _j_fused(words32, glens, tbits, nbands, off=None, rung=None, kind=None):
    """wavefront_fused (interpret mode) fed as decode_indexed_narrow feeds it
    on the TPU: 8-word-aligned window chunks, padded to the grid tile."""
    G_BLK = pick_g_blk(nbands) or 1024
    NREGW, R8, R8sub = fused_params(glens, tbits, G_BLK)
    goff = _goff(glens)
    n = goff.size
    pad = (-n) % G_BLK
    base8 = np.concatenate([goff >> 8, np.repeat(goff[-1] >> 8, pad)]).astype(np.int32)

    def p(x):
        return jnp.asarray(np.concatenate([x, np.zeros(pad, np.int32)]).astype(np.int32))

    w = jnp.asarray(words32.numpy().view(np.uint32))
    if off is None:
        g, r = j_wavefront_fused(w, jnp.asarray(base8), p(goff & 255), p(goff * 0),
                                 p(goff * 0), NREGW, tbits, R8, R8sub, G_BLK,
                                 nbands=nbands, interpret=True)
        return np.asarray(g)[:n].astype(np.uint64), np.asarray(r)[:n]
    g = j_wavefront_fused(w, jnp.asarray(base8), p(off), p(rung), p(kind), NREGW, tbits,
                          R8, R8sub, G_BLK, interpret=True)
    return np.asarray(g)[:n].astype(np.uint64)


FUSED_CASES = {  # (image, mode)
    "u8x3": (lambda: _spiky(corpus.natural8(64, 64, 3, seed=60)), Mode.FTL),
    "u16x8": (lambda: headline_image(64, 64, 8, seed=61, dtype=np.uint16), Mode.BASE_H),
    "u64x1": (lambda: _spiky(headline_image(64, 64, 1, seed=62, dtype=np.uint64)), Mode.FTL),
}


@pytest.mark.parametrize("name", list(FUSED_CASES))
def test_k4_twin_matches_pallas_kernel_parsing(name):
    """In-kernel codeswitch parse and rung chain: values and rungs equal."""
    make, mode = FUSED_CASES[name]
    img = make()
    tbits = img.dtype.itemsize * 8
    words32, glens, _, nb = ix_stream_inputs(img, mode)
    want_g, want_rung = _j_fused(words32, glens, tbits, nb)
    nreg, R = _fused_ix_params(glens, tbits)
    before = wavefront_fused.launches
    g, rung = wavefront_fused(words32, torch.from_numpy(_goff(glens)), nreg, R, tbits,
                              nbands=nb)
    assert wavefront_fused.launches == before  # CPU: the twin
    np.testing.assert_array_equal(g.numpy().view(np.uint64), want_g)
    np.testing.assert_array_equal(rung.numpy(), want_rung)


def test_k4_twin_matches_pallas_kernel_given_rungs():
    """nbands=None: off / rung / kind from the caller (the TPU kernel counts
    off from its 8-word-aligned chunk, the port from the group's word)."""
    img = _spiky(corpus.to_type(corpus.natural8(64, 48, 2, seed=63), np.uint32, 65537))
    words32, glens, _, nb = ix_stream_inputs(img)
    goff = torch.from_numpy(_goff(glens))
    nreg, R = _fused_ix_params(glens, 32)
    regs = tdecode.ix_regs(words32, goff, nreg)
    off, rung, kind = (x.to(torch.int32) for x in tdecode.ix_parse(regs, goff, 32, nb,
                                                                    goff.shape[0]))
    off8 = (off - (goff & 31) + (goff & 255)).numpy()
    want = _j_fused(words32, glens, 32, None, off8, rung.numpy(), kind.numpy())
    got = wavefront_fused(words32, goff, nreg, R, 32, off=off, rung=rung, kind=kind)
    np.testing.assert_array_equal(got.numpy().view(np.uint64), want)


INDEXED_CASES = {  # (images, mode): one image, or 3 tiles in the flat layout
    "u8-ftl": (lambda: [_spiky(corpus.natural8(32, 28, 3, seed=64))], Mode.FTL),
    "u8-base-5-bands": (lambda: [corpus.natural8(24, 20, 5, seed=65)], Mode.BASE_H),
    "u16-flat3-base-z": (lambda: [headline_image(16, 20, 2, seed=s, dtype=np.uint16)
                                  for s in range(3)], Mode.BASE_Z),
    "u32-flat3-5-bands": (lambda: [headline_image(12, 16, 5, seed=s, dtype=np.uint32)
                                   for s in range(3)], Mode.FTL),
    "u64-base": (lambda: [_spiky(headline_image(20, 24, 1, seed=66, dtype=np.uint64))],
                 Mode.BASE_H),
}


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("name", list(INDEXED_CASES))
def test_decode_indexed_narrow_matches_xla_walk(name, fused):
    """K4's twin (fused) and the K5 branch (fused=None), single image and
    flat batches of 3, against decode_indexed_narrow(use_pallas=False)."""
    from qb3_tpu.batch import _flat_tile_layout
    from qb3_tpu.ops.decode import payload_words

    make, mode = INDEXED_CASES[name]
    imgs = make()
    tbits = imgs[0].dtype.itemsize * 8
    streams = [qb3_tpu.encode(im, mode=mode, index=True) for im in imgs]
    infos = [container.parse_headers(s) for s in streams]
    glens = np.stack([np.frombuffer(i.index, "<u2").astype(np.int32) for i in infos])
    n, nb = len(imgs), infos[0].nbands
    nblocks = glens.shape[1] // nb
    if n == 1:
        words, tw32 = qt.api.padded_words(streams[0][infos[0].data_offset:]), 0
    else:
        words, tw32 = _flat_tile_layout([payload_words(s[i.data_offset:])
                                         for s, i in zip(streams, infos)])
    words32 = words.reshape(-1).view(np.uint32)
    nreg, R = _fused_ix_params(glens, tbits, tw32)
    assert nreg == _indexed_nreg(glens, tbits)
    ref = j_decode_indexed(jnp.asarray(words32), jnp.asarray(glens.reshape(-1)), nblocks, nb,
                           mode != Mode.FTL, False, tbits, nreg=nreg, ntiles=n,
                           tile_words32=tw32)
    got = tdecode.decode_indexed_narrow(
        torch.from_numpy(words32.view(np.int32)), torch.from_numpy(glens.reshape(-1)),
        nblocks, nb, mode != Mode.FTL, tbits, n, tw32, nreg, fused=R if fused else None)
    np.testing.assert_array_equal(got.numpy().view(np.uint64),
                                  np.asarray(ref).astype(np.uint64))


def _engine(path):
    """A decode path without the walk's engine: qb3_tpu walks in C++ only
    where its make-built helper loaded, the port where its g++ build did."""
    return "walk" if path.endswith("-walk") else path


def _our_walk():
    return "native-walk" if native.available() else "python-walk"


@pytest.mark.parametrize("name", list(CORPUS))
def test_ix_encode_bytes_and_decode(name):
    """qt.encode(index=True) writes qb3_tpu's bytes, and the port decodes
    them to qb3_tpu's arrays through the "ix" path where qb3_tpu takes it."""
    make, kw = CORPUS[name]
    img = make()
    stream = qt.encode(img, index=True, device="cpu", **kw)
    assert stream == qb3_tpu.encode(img, index=True, **kw)
    info = container.parse_headers(stream)
    ours = qt.Decoder(stream, device="cpu")
    theirs = qb3_tpu.Decoder(stream)
    np.testing.assert_array_equal(ours.read_data(), theirs.read_data())
    assert _engine(ours.decode_path) == _engine(theirs.decode_path)
    if info.mode in (Mode.FTL, Mode.BASE_H, Mode.BASE_Z, Mode.STORED):
        assert ours.decode_path == ("stored" if info.mode == Mode.STORED else "ix")
    else:
        assert ours.decode_path == _our_walk()


def test_ix_string_option_and_rle_stream():
    img = corpus.natural8(20, 24, 2, seed=67)
    assert qt.encode(img, index="ix", device="cpu") == qb3_tpu.encode(img, index="ix")
    rle = qt.encode(CORPUS["rle-h"][0](), mode=Mode.RLE_H, index=True, device="cpu")
    assert container.parse_headers(rle).index is not None
    ours, theirs = qt.Decoder(rle, device="cpu"), qb3_tpu.Decoder(rle)
    np.testing.assert_array_equal(ours.read_data(), theirs.read_data())
    # RLE goes to the walk whatever its sidecar, as in qb3_tpu
    assert ours.decode_path == _our_walk() and theirs.decode_path.endswith("-walk")


def _flip(stream, pos, bit):
    return stream[:pos] + bytes([stream[pos] ^ (1 << bit)]) + stream[pos + 1:]


def _damage(stream, damage):
    info = container.parse_headers(stream)
    if damage == "extra-bytes":
        return stream + b"\x5a\xa5\x0f"
    if damage == "truncated":
        return stream[:-25]
    if damage == "payload-bit-flip":
        return _flip(stream, info.data_offset + 60, 3)
    # a sidecar length: the low byte of the 7th group's u16 glen
    sidecar_at = stream.index(info.index)
    return _flip(stream, sidecar_at + 12, 2)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.uint64])
@pytest.mark.parametrize("damage", ["extra-bytes", "truncated", "payload-bit-flip",
                                    "sidecar-bit-flip"])
def test_damaged_ix_stream_decodes_like_qb3_tpu(damage, dtype):
    img = headline_image(28, 24, 2, seed=68, dtype=dtype)
    stream = _damage(qb3_tpu.encode(img, mode=Mode.BASE_H, index=True), damage)
    outs = []
    for dec in (qt.Decoder(stream, device="cpu"), qb3_tpu.Decoder(stream)):
        try:
            outs.append((dec.read_data(partial=True), dec.failed, _engine(dec.decode_path)))
        except Exception as e:  # both must raise alike
            outs.append(type(e).__name__)
    if isinstance(outs[1], str):
        assert outs[0] == outs[1]
        return
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    assert outs[0][1:] == outs[1][1:]


@pytest.mark.parametrize("dtype,flip", [(np.uint8, 0x0800), (np.uint64, 0x0800),
                                        (np.uint64, 1)])
def test_k4_twin_follows_xla_walk_on_damaged_sidecar(dtype, flip):
    """A flipped sidecar length: + 2048 bits (past _GMAX_IX), or + 1 bit,
    which shifts every later group off its codes while the short groups of
    a smooth image keep nreg small.  The port reads the XLA walk's clamped
    window; the TPU kernel's 8-word-aligned window reads real words there,
    and in the + 1 case decodes other values."""
    img = (corpus.natural8(64, 64, 1, seed=70) // 8).astype(dtype)
    tbits = img.dtype.itemsize * 8
    words32, glens, nblocks, nb = ix_stream_inputs(img, Mode.FTL)
    glens = glens.copy()
    glens[3] ^= flip
    nreg, R = _fused_ix_params(glens, tbits)
    assert (glens.max() > tdecode._GMAX_IX[tbits]) == (flip > 1)
    ref = np.asarray(j_decode_indexed(jnp.asarray(words32.numpy().view(np.uint32)),
                                      jnp.asarray(glens), nblocks, nb, False, False, tbits,
                                      nreg=nreg)).astype(np.uint64)
    got = tdecode.decode_indexed_narrow(words32, torch.from_numpy(glens), nblocks, nb, False,
                                        tbits, nreg=nreg, fused=R)
    np.testing.assert_array_equal(got.numpy().view(np.uint64), ref)
    if flip == 1:
        assert nreg < tdecode._NREG_IX[tbits]
        tpu, _ = _j_fused(words32, glens, tbits, nb)
        assert (tpu != ref).any()


@pytest.mark.parametrize("dtype,mode,nb", [(np.uint8, Mode.FTL, 3), (np.uint16, Mode.BASE_Z, 5),
                                           (np.uint64, Mode.BASE_H, 1)])
def test_ix_tiles_equal(dtype, mode, nb):
    tiles = np.stack([headline_image(24, 20, nb, seed=s, dtype=dtype) for s in range(3)])
    streams = qt.encode_tiles(tiles, mode=mode, index=True, device="cpu")
    assert streams == j_encode_tiles(tiles, mode=mode, index=True)
    assert streams[1] == qt.encode(tiles[1], mode=mode, index=True, device="cpu")
    out = qt.decode_tiles(streams, device="cpu")
    np.testing.assert_array_equal(out, j_decode_tiles(streams))
    np.testing.assert_array_equal(out, tiles)


@pytest.mark.parametrize("dtype,mode", [(np.uint8, Mode.FTL), (np.uint64, Mode.BASE_H)])
def test_indexed_meta_matches(dtype, mode):
    """The "ix" sidecar as decode_groups' metadata: kind, val_pos, rung, cf."""
    img = _spiky(headline_image(24, 28, 3, seed=71, dtype=dtype))
    words32, glens, nblocks, nb = ix_stream_inputs(img, mode)
    ubits = {1: 3, 8: 6}[img.dtype.itemsize]
    ref = jax.jit(jdecode.indexed_meta, static_argnums=(2, 3, 4))(
        jnp.asarray(words32.numpy().view(np.uint64)), jnp.asarray(glens), nblocks, nb, ubits)
    got = tdecode.indexed_meta(words32, torch.from_numpy(glens), nblocks, nb, ubits)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    for g, r in zip(got[1:], ref[1:]):
        np.testing.assert_array_equal(g.numpy().view(np.uint64), np.asarray(r).astype(np.uint64))
