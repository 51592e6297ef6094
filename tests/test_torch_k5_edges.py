"""K5a / K5b's plain twins (qb3_tpu_torch.ops.wavefront_cuda) against
qb3_tpu on the edge inputs of tests/k5_edges.py, on the CPU: every bit
phase, the top rung of each type (u64's rung-63 long form with its 65th
bit inside and past NREG), codes that run past NREG, nreg 1-36, partial
last blocks, CF and CF0 with and without a cf, IDX groups with every max
index 0-7, and kind codes outside 0-5.

Against qb3_tpu's XLA group decode (decode_groups_fused for u8/u16,
decode_groups for u32/u64) on every kind, reading the same bits from each
case's stream, where a window's words past nreg are zero; and against the
TPU kernels wavefront_pallas.wavefront8 / wavefront_wide in interpret mode
on the groups of kinds 0-2 (their domain).  The tolerance is zero.
"""

import numpy as np
import pytest
import torch

from qb3_tpu_torch.offsets import KIND_BITS, KIND_NORMAL, KIND_ZERO

from . import k5_edges
from .test_torch_wavefront import run_jax, run_port, xla_groups

FAST = (KIND_NORMAL, KIND_ZERO, KIND_BITS)  # the Pallas kernels' kinds


def port_groups(name):
    """The twins through the public wrappers on CPU tensors -> (ngroups,
    16) uint64."""
    regs, off, rung, kind, nreg, tbits, cf = k5_edges.k5_case(name)
    args = [torch.from_numpy(x) for x in (regs, off, rung, kind)]
    cf = None if cf is None else torch.from_numpy(cf)
    from qb3_tpu_torch.ops.wavefront_cuda import wavefront8, wavefront_wide

    before = wavefront8.launches + wavefront_wide.launches
    if tbits == 8:
        got = wavefront8(*args, nreg, cf).numpy().view(np.uint32).astype(np.uint64)
    else:
        got = wavefront_wide(*args, nreg, tbits, cf).numpy().view(np.uint64)
    assert wavefront8.launches + wavefront_wide.launches == before  # CPU: the twins
    return got


CPU_CASES = [n for n in k5_edges.CASES if n not in k5_edges.CARD_ONLY]


@pytest.mark.parametrize("name", CPU_CASES)
def test_k5_twin_matches_xla_group_decode_on_edges(name):
    c = k5_edges.stream_case(name)
    meta = dict(kind=c["meta_kind"], val_pos=c["val_pos"], vrung=c["vrung"], cf=c["cf"])
    want = xla_groups(c["words"].view(np.int32), meta, c["tbits"], False)
    np.testing.assert_array_equal(port_groups(name), want)


@pytest.mark.parametrize("name", [n for n in CPU_CASES if set(k5_edges.CASES[n][3]) & set(FAST)])
def test_k5_twin_matches_pallas_kernel_on_edges(name):
    regs, off, rung, kind, nreg, tbits, _ = k5_edges.k5_case(name)
    meta_kind = k5_edges.stream_case(name)["meta_kind"]
    rows = np.isin(meta_kind, FAST)
    assert rows.any()
    args = tuple(torch.from_numpy(np.ascontiguousarray(x[rows]))
                 for x in (regs, off, rung, kind)) + (nreg,)
    np.testing.assert_array_equal(run_port(*args, tbits), run_jax(*args, tbits))


def test_k5_edges_reach_their_edges():
    """The cases hold what they are named for: all 64 phases, long forms
    whose 65th bit lies past a two-word window, every IDX max index 0-7,
    codes outside 0-5 decoding as zero, a null and a given cf."""
    c = k5_edges.stream_case("u8-phases-all-kinds")
    assert set(c["off"].tolist()) == set(range(64))
    regs, off, rung, kind, nreg, tbits, cf = k5_edges.k5_case("u64-rung63-past-nreg-2")
    assert nreg == 2 and (rung == 63).all() and (off < 32).all()
    lo64 = regs.view(np.uint32).astype(np.uint64)
    lo64 = lo64[:, 0] | lo64[:, 1] << np.uint64(32)
    assert (((lo64 >> off.astype(np.uint64)) & np.uint64(3)) == 3).all()
    regs, off, *_ = k5_edges.k5_case("u8-idx-max-0-7")
    tops = set()
    for row, at in zip(regs.view(np.uint32), off):
        bits, top = sum(int(w) << (32 * j) for j, w in enumerate(row)) >> int(at), 0
        for _ in range(16):  # rung-2 plain codes: 0-1 in 2 bits, 2-3 in 3, 4-7 in 4
            if not bits & 1:
                v, n = (bits >> 1) & 1, 2
            elif not bits & 2:
                v, n = 2 | (bits >> 2) & 1, 3
            else:
                v, n = 4 | (bits >> 2) & 3, 4
            top, bits = max(top, v), bits >> n
        tops.add(top)
    assert tops == set(range(8))
    _, _, _, kind, _, _, _ = k5_edges.k5_case("u8-kinds-outside-0-5")
    assert ((kind < 0) | (kind > 5)).all()
    assert not port_groups("u8-kinds-outside-0-5").any()
    assert k5_edges.k5_case("u8-phases-all-kinds")[6] is not None
    assert k5_edges.k5_case("u16-phases-all-kinds")[6] is None
