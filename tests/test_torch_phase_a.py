"""K9's wrapper (qb3_tpu_torch.ops.phase_a_cuda) on the CPU: on a CPU
tensor it returns its twin's outputs (ops/encode.encode_fast_blocks); the
outputs it allocates for the card have the twin's shapes, dtypes and
strides, in disjoint memory; it refuses what the kernel does not take;
every C entry point of csrc/ has the arity of its ctypes signature in
_build.SIGNATURES; profiling.counters() lists K9's launches; and
api.fast_encode opens its encode.phase_a span around the wrapper.

The kernel itself runs in tests/test_torch_cuda.py on the card.  This file
imports neither jax nor qb3_tpu:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_phase_a.py
"""

import glob
import os
import re

import numpy as np
import pytest
import torch

from qb3_tpu_torch import _build, api, profiling
from qb3_tpu_torch.api import to_carrier
from qb3_tpu_torch.benchutil import headline_image
from qb3_tpu_torch.constants import HILBERT, ZCURVE
from qb3_tpu_torch.ops.encode import encode_fast_blocks
from qb3_tpu_torch.ops.phase_a_cuda import MAX_BANDS, phase_a_args, phase_a_fast

from . import pack_edges

NAMES = ("codes", "lens", "exit_prev", "exit_runbits", "rung")

# name -> (dtype, lead + (H, W, C), curve, cband, skipstep)
CASES = {
    "u8 4x4x1": (np.uint8, (4, 4, 1), HILBERT, (0,), True),
    "u8 5x7x3 (1,) base": (np.uint8, (1, 5, 7, 3), HILBERT, (1, 1, 1), False),
    "u16 21x18x4 z": (np.uint16, (21, 18, 4), ZCURVE, (1, 1, 1, 3), True),
    "u32 12x16x16 (3,) base": (np.uint32, (3, 12, 16, 16), HILBERT, (5,) * 16, False),
    "u64 9x13x2 (2, 2) base": (np.uint64, (2, 2, 9, 13, 2), ZCURVE, (0, 0), False),
}


def _inputs(name, seed=0):
    dtype, shape, order, cband, skipstep = CASES[name]
    *lead, h, w, nb = shape
    n = int(np.prod(lead))
    img = np.stack([headline_image(h, w, nb, seed=seed + i, dtype=dtype) for i in range(n)])
    tbits = 8 * np.dtype(dtype).itemsize
    rng = np.random.default_rng(seed)
    prev = rng.integers(0, 1 << min(tbits, 63), (*lead, nb), dtype=np.uint64).astype(dtype)
    runbits = torch.from_numpy(rng.integers(0, tbits, (*lead, nb)).astype(np.int32))
    return (to_carrier(img.reshape(*lead, h, w, nb), "cpu"), to_carrier(prev, "cpu"), runbits,
            order, cband, skipstep, tbits)


@pytest.mark.parametrize("with_rungs", [True, False])
@pytest.mark.parametrize("name", list(CASES))
def test_phase_a_fast_on_cpu_is_the_twin(name, with_rungs):
    a = _inputs(name, seed=11)
    before = phase_a_fast.launches
    got = phase_a_fast(*a, with_rungs=with_rungs)
    assert phase_a_fast.launches == before  # the CPU takes the twin
    want = encode_fast_blocks(*a, with_rungs=with_rungs)
    assert len(got) == len(want) == 4 + with_rungs
    for what, g, w in zip(NAMES, got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), what


@pytest.mark.parametrize("name", list(pack_edges.K9_CASES))
def test_phase_a_fast_edges_on_cpu_are_the_twins(name):
    """The K9 edge inputs reach what they are for, and the wrapper on a CPU
    tensor returns the twin's outputs there, FTL and BASE."""
    img, order = pack_edges.k9_case(name)
    nb, tbits = img.shape[-1], 8 * img.itemsize
    x, zero = to_carrier(img, "cpu"), torch.zeros(nb, dtype=torch.int64)
    for skipstep in (True, False):
        got = phase_a_fast(x, zero, zero, order, tuple(range(nb)), skipstep, tbits, True)
        want = encode_fast_blocks(x, zero, zero, order, tuple(range(nb)), skipstep, tbits, True)
        for what, g, w in zip(NAMES, got, want):
            assert torch.equal(g, w), what
    codes, lens, _, _, rung = got
    if name == "zero-groups":
        assert int((lens[:, 1:].sum(-1) == 0).sum()) > 0  # groups that code no value bit
    if name == "bitsused-1":
        assert int(rung.max()) == 0 and int((lens[:, 1:] == 1).sum()) > 0
    if name.startswith("steps"):
        assert sorted(set(rung.flatten().tolist())) == pack_edges.K9_STEP_RUNGS[name]
    if name in ("u64-rung-63", "steps-u64", "max-u64"):
        assert int(rung.max()) == 63 and int((lens[:, 2::2] == 1).sum()) > 0  # 65th bits
    if name.startswith("max-"):
        assert int(rung.max()) == tbits - 1


@pytest.mark.parametrize("with_rungs", [True, False])
@pytest.mark.parametrize("name", list(CASES))
def test_phase_a_args_allocate_the_twins_outputs(name, with_rungs):
    """The outputs allocated for the card: the twin's shapes and dtypes,
    contiguous, each in its own bytes; the entry point's arguments less
    the stream, pointers to them."""
    a = _inputs(name, seed=12)
    args, out = phase_a_args(*a, with_rungs)
    want = encode_fast_blocks(*a, with_rungs=with_rungs)
    assert len(args) == len(_build.SIGNATURES["qb3_phase_a_fast"]) - 1
    spans = []
    for what, g, w in zip(NAMES, out, want):
        assert g.shape == w.shape and g.dtype == w.dtype and g.is_contiguous(), what
        spans.append((g.data_ptr(), g.data_ptr() + g.numel() * g.element_size()))
    spans.sort()
    assert all(a1 <= b0 for (_, a1), (b0, _) in zip(spans, spans[1:]))
    ptrs = [args[i] for i in (12, 13, 14, 15, 16)]  # codes, lens, rung, exit_prev, exit_run
    assert ptrs[:2] == [out[0].data_ptr(), out[1].data_ptr()]
    assert ptrs[3:] == [out[2].data_ptr(), out[3].data_ptr()]
    assert ptrs[2] == (out[4].data_ptr() if with_rungs else None)
    *lead, h, w, nb = a[0].shape
    assert args[5:12] == (int(np.prod(lead)), h, w, nb, a[6], a[3], int(a[5]))


def _refused(**change):
    img = torch.zeros(8, 8, 3, dtype=torch.int64)
    z = torch.zeros(3, dtype=torch.int64)
    a = dict(img=img, entry_prev=z, entry_runbits=z, order=HILBERT, cband=(1, 1, 1),
             skipstep=True, tbits=8, with_rungs=True)
    a.update(change)
    return a


@pytest.mark.parametrize("change,error", [
    (dict(tbits=12), ValueError),
    (dict(img=torch.zeros(3, 8, 3, dtype=torch.int64)), ValueError),
    (dict(img=torch.zeros(8, 8, 3, dtype=torch.int32)), TypeError),
    (dict(img=torch.zeros(8, 3, 8, dtype=torch.int64).transpose(1, 2)), ValueError),
    (dict(img=torch.zeros(4, 4, MAX_BANDS + 1, dtype=torch.int64)), ValueError),
    (dict(cband=(1, 1)), ValueError),
    (dict(cband=(0, 3, 2)), ValueError),
    (dict(entry_prev=torch.zeros(2, 3, dtype=torch.int64)), ValueError),
    (dict(entry_runbits=torch.zeros(3, dtype=torch.int16)), TypeError),
])
def test_phase_a_args_refuse_what_the_kernel_does_not_take(change, error):
    with pytest.raises(error):
        phase_a_args(**_refused(**change))


def _entry_points():
    """extern "C" entry point name -> its parameter count, from csrc/*.cu."""
    out = {}
    for path in sorted(glob.glob(os.path.join(_build.SRC_DIR, "*.cu"))):
        with open(path) as f:
            src = f.read()
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src):
            out[name] = len([p for p in params.split(",") if p.strip()])
    return out


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_signatures_match_the_entry_points(name):
    """Each ctypes signature names an entry point of csrc/ with as many
    parameters (K9's qb3_phase_a_fast among them)."""
    points = _entry_points()
    assert "qb3_phase_a_fast" in points and sorted(points) == sorted(_build.SIGNATURES)
    assert points[name] == len(_build.SIGNATURES[name])


def test_counters_list_k9s_launches(monkeypatch):
    monkeypatch.setattr(phase_a_fast, "launches", 7)
    assert profiling.counters()["phase_a_fast"] == 7


def test_fast_encode_opens_phase_a_around_k9(monkeypatch):
    """api.fast_encode calls K9's wrapper inside its encode.phase_a span
    (the span phase_a_ms_per_tile.encode reads), and K1's pack after it."""
    seen = []

    def k9(*a, **k):
        with profiling.span("probe"):
            seen.append(1)
        return phase_a_fast(*a, **k)

    monkeypatch.setattr(api, "phase_a_fast", k9)
    img = to_carrier(headline_image(16, 20, 3, seed=5)[None], "cpu")
    zero = torch.zeros(1, 3, dtype=torch.int64)
    profiling.enable()
    try:
        api.fast_encode(img, zero, zero, HILBERT, (1, 1, 1), True, 8,
                        api.stream_words(20, 16, 3, 0))
    finally:
        profiling.disable()
    recs = {r["name"]: r for r in profiling.records()}
    assert seen == [1]
    assert recs["probe"]["parent"] == recs["encode.phase_a"]["id"]
    assert recs["encode.phase_a"]["tiles"] == 1
    assert recs["encode.pack"]["t0_ns"] >= recs["encode.phase_a"]["t1_ns"]
