"""K4's and K2's plain twins (qb3_tpu_torch.ops.fusedwin_cuda,
ops.chunkwalk_cuda) against qb3_tpu's walks on the walks' edge inputs
(tests/walk_edges.py), on the CPU.

K4's twin goes through decode_indexed_narrow and is held to qb3_tpu's XLA
walk (decode_indexed_narrow, use_pallas=False), and in the caller-given
mode to its own parsing mode.  K2's twin goes through decode_chunked_auto
(K3's windows, then the walk) and is held to qb3_tpu's decode_chunked where
qb3_tpu's walk compiles in seconds (up to 3 bands; at 8 bands it takes ~40
s), and to the port's walk on the stream itself beyond.  The card tests
(test_torch_cuda.py) hold the kernels to the twins on the same inputs.  The
tolerance is zero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qb3_tpu.ops import decode as jdecode
from qb3_tpu.ops import decode_chunked as jdc
from qb3_tpu_torch.api import _fused_ix_params
from qb3_tpu_torch.ops import decode as tdecode
from qb3_tpu_torch.ops import decode_chunked as tdc
from qb3_tpu_torch.ops.fusedwin_cuda import wavefront_fused

from . import walk_edges

j_decode_indexed = jax.jit(jdecode.decode_indexed_narrow, static_argnums=(2, 3, 4, 5, 6),
                           static_argnames=("nreg", "ntiles", "tile_words32"))
j_decode_chunked = jax.jit(jdc.decode_chunked, static_argnums=(3, 4, 5, 6, 7))


@pytest.mark.parametrize("name", sorted(set(walk_edges.K4_CASES) - walk_edges.CARD_ONLY))
def test_k4_twin_matches_xla_walk_on_edges(name):
    words32, glens, tbits, nb, nblocks, ntiles, tw32, step = walk_edges.k4_case(name)
    nreg, R = _fused_ix_params(glens.reshape(ntiles, -1), tbits, tw32)
    ref = j_decode_indexed(jnp.asarray(words32.view(np.uint32)), jnp.asarray(glens), nblocks, nb,
                           step, False, tbits, nreg=nreg, ntiles=ntiles, tile_words32=tw32)
    w = torch.from_numpy(words32)
    before = wavefront_fused.launches
    got = tdecode.decode_indexed_narrow(w, torch.from_numpy(glens), nblocks, nb, step, tbits,
                                        ntiles, tw32, nreg, fused=R)
    assert wavefront_fused.launches == before  # CPU: the twin
    np.testing.assert_array_equal(got.numpy().view(np.uint64), np.asarray(ref).astype(np.uint64))
    # the caller-given mode, fed the parse's off / rung / kind
    per_tile = nblocks * nb
    g2 = torch.from_numpy(glens.astype(np.int64)).reshape(ntiles, per_tile)
    goff = (torch.cumsum(g2, 1) - g2 + torch.arange(ntiles)[:, None] * tw32 * 32).reshape(-1)
    goff = goff.to(torch.int32)
    regs = tdecode.ix_regs(w, goff, nreg)
    off, rung, kind = (x.to(torch.int32) for x in tdecode.ix_parse(regs, goff, tbits, nb,
                                                                    per_tile))
    given = wavefront_fused(w, goff, nreg, R, tbits, off=off, rung=rung, kind=kind,
                            apply_step=step)
    assert torch.equal(given, got)


@pytest.mark.parametrize("name", list(walk_edges.K2_CASES))
def test_k2_twin_matches_walk_on_edges(name):
    words32, starts, entry, ubits, nb, k, step, maxw, R = walk_edges.k2_case(name)
    tbits = 8 if ubits == 3 else 16
    nblocks = starts.size * k
    w, st, en = (torch.from_numpy(x) for x in (words32, starts, entry))
    got = tdc.decode_chunked_auto(w, st, en, k, nblocks, nb, step, tbits, maxw, R)
    if nb <= 3:
        ref = np.asarray(j_decode_chunked(jnp.asarray(words32.view(np.uint32)),
                                          jnp.asarray(starts), jnp.asarray(entry), k, nblocks,
                                          nb, step, tbits)).astype(np.uint64)
    else:
        ref = tdc.decode_chunked(w, st, en, k, nblocks, nb, step, tbits).numpy().view(np.uint64)
    np.testing.assert_array_equal(got.numpy().view(np.uint64), ref)
