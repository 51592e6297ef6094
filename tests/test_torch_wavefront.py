"""K5a / K5b's plain twins (qb3_tpu_torch.ops.wavefront_cuda) against the
TPU kernels qb3_tpu.ops.wavefront_pallas.wavefront8 / wavefront_wide run in
interpret mode on kinds 0-2, and against qb3_tpu's XLA group decode
(decode_groups_fused for u8/u16, decode_groups for u32/u64) on every kind,
the best modes' CF, CF0 and IDX included, on the CPU; and the port's K5
branch of decode_indexed_narrow against the JAX package's XLA walk.

Inputs are made with numpy from a seed: register windows gathered from
qb3_tpu "ix" streams as decode_indexed_narrow gathers them, random garbage
windows, the walk's groups of qb3_tpu best-mode streams, and random group
metadata over the walk's domain.  The tolerance is zero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qb3_tpu
from qb3_tpu import container
from qb3_tpu.constants import Mode
from qb3_tpu.ops import decode as jdecode
from qb3_tpu.ops.wavefront_pallas import wavefront8 as j_wavefront8
from qb3_tpu.ops.wavefront_pallas import wavefront_wide as j_wavefront_wide
from qb3_tpu_torch import api, offsets
from qb3_tpu_torch.api import _indexed_nreg, padded_words
from qb3_tpu_torch.constants import HILBERT, curve_offsets
from qb3_tpu_torch.ops import decode as tdecode
from qb3_tpu_torch.ops.gather_cuda import gather_slabs
from qb3_tpu_torch.ops.wavefront_cuda import wavefront8, wavefront_wide

from . import corpus

G_BLK = 128  # the Pallas kernels' group tile; inputs are padded to it


def ix_stream_inputs(img, mode=Mode.FTL):
    """(words32 int32 tensor, glens int32 array, nblocks, nbands) of the
    qb3_tpu "ix" stream of img."""
    stream = qb3_tpu.encode(img, mode=mode, index=True)
    info = container.parse_headers(stream)
    glens = np.frombuffer(info.index, "<u2").astype(np.int32)
    nblocks = glens.size // info.nbands
    words32 = torch.from_numpy(padded_words(stream[info.data_offset:]).view(np.int32))
    return words32, glens, nblocks, info.nbands


def k5_inputs(img, mode=Mode.FTL):
    """K5's inputs as decode_indexed_narrow's fused=None branch builds them."""
    words32, glens, nblocks, nb = ix_stream_inputs(img, mode)
    tbits = img.dtype.itemsize * 8
    nreg = _indexed_nreg(glens, tbits)
    goff = torch.from_numpy((np.cumsum(glens) - glens).astype(np.int32))
    regs = tdecode.ix_regs(words32, goff, nreg)
    off, rung, kind = tdecode.ix_parse(regs, goff, tbits, nb, goff.shape[0])
    return (regs[:, :nreg].to(torch.int32), off.to(torch.int32), rung.to(torch.int32),
            kind.to(torch.int32), nreg)


def run_jax(regs, off, rung, kind, nreg, tbits):
    """The Pallas kernel in interpret mode, padded to G_BLK with zero groups."""
    n = regs.shape[0]
    pad = (-n) % G_BLK

    def p(x):
        x = x.numpy()
        return jnp.asarray(np.concatenate([x, np.zeros((pad, *x.shape[1:]), x.dtype)]))

    regs_j = jnp.asarray(np.concatenate([regs.numpy().view(np.uint32),
                                         np.zeros((pad, nreg), np.uint32)]))
    if tbits == 8:
        out = j_wavefront8(regs_j, p(off), p(rung), p(kind), nreg, G_BLK, interpret=True)
    else:
        out = j_wavefront_wide(regs_j, p(off), p(rung), p(kind), nreg, tbits, G_BLK,
                               interpret=True)
    return np.asarray(out)[:n].astype(np.uint64)


def run_port(regs, off, rung, kind, nreg, tbits):
    if tbits == 8:
        before = wavefront8.launches
        got = wavefront8(regs, off, rung, kind, nreg)
        assert got.dtype == torch.int32 and wavefront8.launches == before  # CPU: the twin
        return got.numpy().view(np.uint32).astype(np.uint64)
    before = wavefront_wide.launches
    got = wavefront_wide(regs, off, rung, kind, nreg, tbits)
    assert got.dtype == torch.int64 and wavefront_wide.launches == before
    return got.numpy().view(np.uint64)


def _spiky(img):
    img = img.copy()
    img[::8, ::8] = np.iinfo(img.dtype).max  # 0 <-> max spikes: the widest codes
    img[4::8, 2::8] = 0
    return img


VALID = {
    "u8": lambda: _spiky(corpus.natural8(32, 40, 3, seed=40)),
    "u16": lambda: _spiky(corpus.to_type(corpus.natural8(32, 32, 2, seed=41), np.uint16, 300)),
    "u32": lambda: _spiky(corpus.to_type(corpus.natural8(24, 32, 1, seed=42), np.uint32, 65537)),
    "u64": lambda: _spiky(corpus.to_type(corpus.natural8(24, 24, 1, seed=43), np.uint64,
                                         (1 << 40) + 3)),
}


@pytest.mark.parametrize("name", list(VALID))
def test_k5_twin_matches_pallas_kernel_on_valid_windows(name):
    img = VALID[name]()
    tbits = img.dtype.itemsize * 8
    args = k5_inputs(img)
    np.testing.assert_array_equal(run_port(*args, tbits), run_jax(*args, tbits))


@pytest.mark.parametrize("tbits", [8, 16, 32, 64])
def test_k5_twin_matches_pallas_kernel_on_garbage(tbits):
    """Random windows, offsets, rungs and kinds over the kernels' domain:
    walks that run past the window read zero in both."""
    rng = np.random.default_rng(tbits)
    n, nreg = 300, {8: 8, 16: 12, 32: 20, 64: 36}[tbits]
    regs = torch.from_numpy(rng.integers(-2**31, 2**31, (n, nreg), dtype=np.int64)
                            .astype(np.int32))
    off = torch.from_numpy(rng.integers(0, 64, n).astype(np.int32))
    rung = torch.from_numpy(rng.integers(0, tbits, n).astype(np.int32))
    kind = torch.from_numpy(rng.integers(0, 3, n).astype(np.int32))
    if tbits == 64:
        rung[:40] = 63  # the 65-bit long form
    args = (regs, off, rung, kind, nreg)
    np.testing.assert_array_equal(run_port(*args, tbits), run_jax(*args, tbits))


@pytest.mark.parametrize("name,mode", [("u8", Mode.FTL), ("u8", Mode.BASE_H),
                                       ("u16", Mode.BASE_Z), ("u64", Mode.FTL)])
def test_k5_branch_matches_xla_walk(name, mode):
    """decode_indexed_narrow(fused=None): windows gathered by indexing, the
    parse, the K5 twin and the step restore, against the JAX walk."""
    img = VALID[name]()
    tbits = img.dtype.itemsize * 8
    words32, glens, nblocks, nb = ix_stream_inputs(img, mode)
    nreg = _indexed_nreg(glens, tbits)
    ref = jax.jit(jdecode.decode_indexed_narrow, static_argnums=(2, 3, 4, 5, 6),
                  static_argnames=("nreg",))(
        jnp.asarray(words32.numpy().view(np.uint32)), jnp.asarray(glens), nblocks, nb,
        mode != Mode.FTL, False, tbits, nreg=nreg)
    got = tdecode.decode_indexed_narrow(words32, torch.from_numpy(glens), nblocks, nb,
                                        mode != Mode.FTL, tbits, nreg=nreg)
    np.testing.assert_array_equal(got.numpy().view(np.uint64),
                                  np.asarray(ref).astype(np.uint64))


def best_scene(h, w, c, dtype, seed, step=None):
    """A raster whose best-mode (Hilbert) stream holds CF, CF0 and IDX
    groups, made in scan order (blocks in raster order, the Hilbert curve
    inside each): a third of the values step by multiples of 12 (CF
    groups), a third are one of three values `step` apart (IDX), a third
    drop by 3 or stay (CF0: every value divided by 3 is 0 or -1), wrapping
    at the type's width.  A small step keeps every common factor within
    the "ib" sidecar's 16 bits."""
    rng = np.random.default_rng(seed)
    top = np.iinfo(dtype).max
    nby, nbx = h // 4, w // 4
    n = nby * nbx * 16
    t = n // 3
    dy, dx = np.array(curve_offsets(HILBERT)).T
    out = np.empty((nby, nbx, 4, 4, c), dtype)
    for b in range(c):
        d = np.concatenate([12 * rng.integers(-3, 4, t), np.zeros(t, np.int64),
                            -3 * rng.integers(0, 2, n - 2 * t)])
        seq = np.cumsum(d.astype(np.uint64)) + np.uint64(top // 2)  # wraps at 64 bits
        step = step or top // 9 + 1  # deltas under 2^62: u64 IDX below rung 63
        seq[t: 2 * t] = (np.uint64(top // 2) + np.array([0, step, 3 * step], np.uint64))[
            rng.integers(0, 3, t)]
        out[:, :, dy, dx, b] = seq.astype(dtype).reshape(nby, nbx, 16)
    return out.transpose(0, 2, 1, 3, 4).reshape(h, w, c)


def xla_groups(words, meta, tbits, apply_step):
    """qb3_tpu's group decode of walk metadata, as its decoder runs it on the
    CPU: decode_groups_fused without the MXU (u8/u16), decode_groups
    (u32/u64) -> (ngroups, 16) uint64."""
    flat = [jnp.asarray(meta[k].reshape(-1)) for k in ("kind", "val_pos", "vrung", "cf")]
    w32 = jnp.asarray(words.view(np.uint32))
    if tbits <= 16:
        g = jax.jit(jdecode.decode_groups_fused, static_argnums=(5, 6, 7))(
            w32, *flat, apply_step, tbits, False)
    else:
        g, _ = jax.jit(jdecode.decode_groups, static_argnums=(5,))(w32, *flat, apply_step)
    return np.asarray(g).astype(np.uint64)


def k5_walk_groups(words, meta, tbits):
    """K7's and K5's twins on walk metadata, as decode_groups runs them,
    before the step restore of kind-1 groups -> (ngroups, 16) uint64."""
    inp = api.group_inputs(meta, words.view(np.uint32).size, tbits, "cpu")
    regs = gather_slabs(torch.from_numpy(words.view(np.int32)), inp["base"], inp["nreg"],
                        inp["R"])
    args = (regs, inp["off"], inp["rung"], inp["kind"], inp["nreg"])
    before = wavefront8.launches + wavefront_wide.launches
    if tbits == 8:
        got = wavefront8(*args, inp["cf"]).numpy().view(np.uint32).astype(np.uint64)
    else:
        got = wavefront_wide(*args, tbits, inp["cf"]).numpy().view(np.uint64)
    assert wavefront8.launches + wavefront_wide.launches == before  # CPU: the twins
    return got


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.uint32, np.uint64])
def test_k5_twin_matches_xla_group_decode_on_best_streams(dtype):
    """The walk's groups of a CF_H stream holding CF, CF0 and IDX groups: the
    twins equal qb3_tpu's group decode with the kind-1 step restore off (it
    stays with decode_groups), which restores and multiplies CF groups."""
    img = best_scene(24, 20, 2, dtype, seed=50)
    stream = qb3_tpu.encode(img, mode=Mode.CF_H)
    info = container.parse_headers(stream)
    data = stream[info.data_offset:]
    tbits = 8 * img.itemsize
    meta = offsets.parse_offsets(data, 30, 2, img.itemsize, info.mode)
    counts = np.bincount(meta["kind"].reshape(-1), minlength=6)
    assert (counts[[offsets.KIND_CF, offsets.KIND_CF0, offsets.KIND_IDX]] > 0).all(), counts
    words = padded_words(data)
    np.testing.assert_array_equal(k5_walk_groups(words, meta, tbits),
                                  xla_groups(words, meta, tbits, False))


@pytest.mark.parametrize("tbits", [8, 16, 32, 64])
def test_k5_twin_matches_xla_group_decode_on_garbage(tbits):
    """Random stream words and group metadata over the walk's domain (every
    kind; rungs below the width, group-coded ones from 1; any cf): the
    window holds the longest group of any kind from any phase, so the twins
    read what qb3_tpu reads, and agree with its group decode."""
    rng = np.random.default_rng(60 + tbits)
    n = 600
    words = rng.integers(0, 1 << 64, 64 * n, dtype=np.uint64)
    words[-64:] = 0
    kind = rng.integers(0, 6, n).astype(np.uint8)
    vrung = rng.integers(0, tbits, n).astype(np.int32)
    grouped = (kind == offsets.KIND_NORMAL) | (kind == offsets.KIND_CF)
    vrung = np.where(grouped & (vrung == 0), 1, vrung).astype(np.int32)
    vrung[:50] = tbits - 1  # the widest codes, u64's 65-bit form
    meta = dict(kind=kind, vrung=vrung,
                val_pos=np.sort(rng.integers(0, 64 * 64 * (n - 2), n)).astype(np.int64),
                cf=rng.integers(0, 1 << 64, n, dtype=np.uint64))
    np.testing.assert_array_equal(k5_walk_groups(words, meta, tbits),
                                  xla_groups(words, meta, tbits, False))
