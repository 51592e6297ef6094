"""The wrapper of K11 (qb3_tpu_torch.ops.quantize_cuda) on the CPU, and the
encoders' route through it: on a CPU tensor quantize_carrier is api.quantize
followed by the widening, on every case of tests/quantize_edges.py, and so
is K11's arithmetic written out on Python integers; the output it allocates
for the card; its refusals; its launches in profiling.counters(); the
one-shot encode calls it once, in no span of its own, at a step of 2 or
more and never at step 1.

The kernel itself runs in tests/test_torch_cuda.py on the card.  This file
imports neither jax nor qb3_tpu:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_quantize.py
"""

import numpy as np
import pytest
import torch

import qb3_tpu_torch as qt
from qb3_tpu_torch import api, container, profiling
from qb3_tpu_torch.api import quantize, widen
from qb3_tpu_torch.ops.quantize_cuda import SOURCE, quantize_args, quantize_carrier

from . import quantize_edges


@pytest.mark.parametrize("name", list(quantize_edges.CASES))
def test_k11_twin_is_quantize_then_widen(name):
    dtype, q, away = quantize_edges.CASES[name]
    arr = quantize_edges.values(dtype, q)
    bits = np.iinfo(dtype).bits
    size = bits // 8
    values = torch.from_numpy(quantize_edges.signed_view(arr).copy())
    assert values.dtype == SOURCE[bits]
    got = quantize_carrier(values, bits, np.iinfo(dtype).min < 0, q, away)
    want = widen(torch.from_numpy(quantize_edges.signed_view(quantize(arr, q, away))), size)
    assert got.dtype == torch.int64 and torch.equal(got, want)
    model = quantize_edges.k11_model(arr, q, away)
    np.testing.assert_array_equal(got.numpy().astype(np.uint64), model.astype(np.uint64))


def test_quantize_args_allocate_the_output():
    values = torch.zeros(3, 5, 2, dtype=torch.int16)
    args, out = quantize_args(values, 16, True, 4, False)
    assert out.shape == values.shape and out.dtype == torch.int64 and out.is_contiguous()
    assert args == (values.data_ptr(), 30, 16, 1, 4, 0, out.data_ptr())


@pytest.mark.parametrize("change,error", [
    (dict(tbits=12), ValueError),
    (dict(values=torch.zeros(8, dtype=torch.uint16)), TypeError),
    (dict(values=torch.zeros(4, 4, dtype=torch.int16).t()), ValueError),
    (dict(q=1), ValueError),
    (dict(q=32768), ValueError),
    (dict(tbits=8, values=torch.zeros(8, dtype=torch.uint8), signed=False, q=256), ValueError),
    (dict(tbits=8, values=torch.zeros(8, dtype=torch.int8)), TypeError),
])
def test_quantize_args_refuse_what_the_kernel_does_not_take(change, error):
    kw = dict(values=torch.zeros(8, dtype=torch.int16), tbits=16, signed=True, q=4, away=False)
    kw.update(change)
    with pytest.raises(error):
        quantize_args(**kw)


def test_counters_list_k11s_launches(monkeypatch):
    monkeypatch.setattr(quantize_carrier, "launches", 11)
    assert profiling.counters()["quantize_carrier"] == 11


@pytest.mark.parametrize("quanta", [1, 4])
def test_one_shot_encode_quantizes_through_k11s_wrapper(monkeypatch, quanta):
    """Encoder.encode hands K11's wrapper the raster's values once, in no
    span of its own (the strip encoder alone opens strip.quantize), at a
    step of 2 or more, and not at step 1; the stream
    is the one the host quantizer's route gave (api.quantize, then the
    encode at the step), and the CPU launches nothing."""
    rng = np.random.default_rng(31)
    img = (np.cumsum(rng.integers(-3, 4, (24, 20, 1)), axis=1) * 40 - 300).astype(np.int16)
    seen = []

    def k11(*a, **k):
        with profiling.span("probe"):
            seen.append(a[1:])
        return quantize_carrier(*a, **k)

    monkeypatch.setattr(api, "quantize_carrier", k11)
    launches = quantize_carrier.launches
    profiling.enable()
    try:
        stream = qt.encode(img, quanta=quanta, device="cpu")
    finally:
        profiling.disable()
    recs = {r["name"]: r for r in profiling.records()}
    assert quantize_carrier.launches == launches
    if quanta == 1:
        assert seen == [] and "probe" not in recs
        return
    assert seen == [(16, True, 4, False)]
    assert recs["probe"]["parent"] is None and "strip.quantize" not in recs
    # the host quantizer's route: the quantized raster at step 1, the step in the header
    want = qt.encode(quantize(img, 4, False), device="cpu")
    info, plain = container.parse_headers(stream), container.parse_headers(want)
    assert info.quanta == 4 and plain.quanta == 1
    assert stream[info.data_offset:] == want[plain.data_offset:]
