"""K5a / K5b's plain twins (qb3_tpu_torch.ops.wavefront_cuda) against the
TPU kernels qb3_tpu.ops.wavefront_pallas.wavefront8 / wavefront_wide run in
interpret mode, on the CPU, and the port's K5 branch of
decode_indexed_narrow against the JAX package's XLA walk.

Inputs are made with numpy from a seed: register windows gathered from
qb3_tpu "ix" streams as decode_indexed_narrow gathers them, and random
garbage windows.  The tolerance is zero.
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
from qb3_tpu_torch.api import _indexed_nreg, padded_words
from qb3_tpu_torch.ops import decode as tdecode
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
