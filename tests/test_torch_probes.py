"""The port's Mosaic probes (qb3_tpu_torch.probes, P1-P7's twins in
ops/probe_cuda) against tools/probe_mosaic.py, on the CPU.

Each probe of the port runs on device="cpu" (its kernel's plain twin) and
passes the probe's own NumPy check; the JAX probe runs with pl.pallas_call
wrapped to interpret=True by a monkeypatch (the file is unchanged; its
probes take no interpret argument) and prints its OK line too, the DMA
probes P2 and P4 included.  The wrapper also records the JAX kernel's
inputs and output: the port's probe must build the same inputs, and its
wrapper and twin must return the same output on them.  The tolerance is
zero.  P1's twin is also held to jax.lax.dot_general, the body of its
probe's kernel, at the CPU shapes of tests/p1_cases.py: exactly on
integer-valued inputs, within 2^-16 of the sum of |a_km b_kn| on random
bf16 ones (two float32 summation orders).
"""

import functools
import importlib.util
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from qb3_tpu_torch import probes
from qb3_tpu_torch.ops import probe_cuda

from . import p1_cases

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LINES = {"dim0_dot": "dim0-contraction dot", "1d_dma": "1-D HBM arbitrary-offset DMA",
         "flatten": "sublane->lane flatten", "3d_dma": "3-D middle-dim DMA",
         "lane_write": "lane-offset write @64", "lane_concat": "lane concat 4x48",
         "flatten_big": "flatten (544,8)->(1,4352)"}


@pytest.fixture(scope="module")
def mosaic():
    """tools/probe_mosaic.py, loaded as a module (its P5-P7 lie past its
    __main__ block, so they are reached as attributes)."""
    spec = importlib.util.spec_from_file_location(
        "probe_mosaic", os.path.join(ROOT, "tools", "probe_mosaic.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", list(LINES))
def test_probe_on_cpu_and_the_jax_probe_print_ok(name, mosaic, monkeypatch, capsys):
    """The port's probe prints OK on the CPU, with no kernel launched; the
    JAX probe prints OK in interpret mode; the port builds the JAX probe's
    own inputs (recorded from its pallas_call), and the port's wrapper and
    twin, fed those inputs, return the JAX kernel's output (up to its
    shape: P2's copy is one row per offset)."""
    launches = {k: getattr(probe_cuda, k).launches for k in
                ("dim0_dot", "dma_1d", "flatten", "dma_3d", "lane_write", "lane_concat",
                 "flatten_big")}
    assert probes.PROBES[name](device="cpu")
    assert capsys.readouterr().out == f"{LINES[name]}: OK\n"
    assert launches == {k: getattr(probe_cuda, k).launches for k in launches}  # CPU: twins
    calls, real = [], pl.pallas_call

    def recording(kernel, **kw):
        run = real(kernel, interpret=True, **kw)

        def call(*args):
            out = run(*args)
            calls.append(([np.asarray(x) for x in args], np.asarray(out)))
            return out
        return call

    monkeypatch.setattr(pl, "pallas_call", recording)
    getattr(mosaic, "probe_" + name)()
    assert capsys.readouterr().out == f"{LINES[name]}: OK\n"
    ((jax_in, jax_out),) = calls
    if name in ("1d_dma", "3d_dma"):
        jax_in = jax_in[::-1]  # the TPU kernel takes (offsets, source)
    args = probes.probe_inputs(name, "cpu")
    tensors = [x for x in args if torch.is_tensor(x)]
    assert len(tensors) == len(jax_in)
    given = []
    for t, j in zip(tensors, jax_in):
        assert t.shape == j.shape and str(t.dtype).endswith(str(j.dtype)), (t.dtype, j.dtype)
        np.testing.assert_array_equal(t.float().numpy(), j.astype(np.float32))
        given.append(torch.from_numpy(j.astype(np.float32)).to(t.dtype))
    given += [x for x in args if not torch.is_tensor(x)]
    kern, plain = probes.KERNELS[name]
    for fn in (kern, plain):
        got = fn(*given).numpy()
        assert got.dtype == jax_out.dtype and got.size == jax_out.size
        np.testing.assert_array_equal(got.reshape(jax_out.shape), jax_out)


def test_module_runs_the_default_four_and_every_named_probe(capsys):
    assert probes.main(["--device", "cpu"]) == 0
    assert capsys.readouterr().out.splitlines() == [
        f"{LINES[n]}: OK" for n in ("dim0_dot", "1d_dma", "flatten", "3d_dma")]
    assert probes.main(["--device", "cpu", *LINES]) == 0
    assert capsys.readouterr().out.splitlines() == [f"{v}: OK" for v in LINES.values()]
    assert probes.main(["--device", "cpu", "flatten", "no_such_probe"]) == 1
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"{LINES['flatten']}: OK" and out[1].startswith("no_such_probe: FAIL")


def test_twins_outside_the_probes_shapes():
    """The twins' edges, which the probes' checks do not reach: offsets that
    leave the source read zero, the lane write's zeros, a rectangular
    contraction."""
    src = torch.arange(10, dtype=torch.int32)
    got = probe_cuda.dma_1d(src, torch.tensor([-2, 7], dtype=torch.int32), 5)
    np.testing.assert_array_equal(got.numpy(), [[0, 0, 0, 1, 2], [7, 8, 9, 0, 0]])
    src3 = torch.arange(2 * 5 * 3, dtype=torch.int32).reshape(2, 5, 3)
    got = probe_cuda.dma_3d(src3, torch.tensor([3], dtype=torch.int32), 4)
    want = np.zeros((2, 4, 3), np.int32)
    want[:, :2] = src3.numpy()[:, 3:]
    np.testing.assert_array_equal(got.numpy(), want)
    x = torch.arange(6, dtype=torch.int32).reshape(2, 3) + 1
    got = probe_cuda.lane_write(x, 7, 2).numpy()
    np.testing.assert_array_equal(got[:, 2:5], x.numpy())
    assert not got[:, :2].any() and not got[:, 5:].any()
    rng = np.random.default_rng(5)
    a, b = (torch.from_numpy(rng.integers(-8, 8, s).astype(np.float32)).to(torch.bfloat16)
            for s in ((33, 5), (33, 9)))
    np.testing.assert_array_equal(probe_cuda.dim0_dot(a, b).numpy(),
                                  a.float().numpy().T @ b.float().numpy())
    np.testing.assert_array_equal(probe_cuda.lane_concat(x, 3).numpy(),
                                  np.concatenate([x.numpy() + i for i in range(3)], axis=1))
    np.testing.assert_array_equal(probe_cuda.flatten(x).numpy(), x.numpy().reshape(1, -1))


@pytest.mark.parametrize("integer", [True, False], ids=["integer", "random"])
@pytest.mark.parametrize("shape", p1_cases.CPU_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_dim0_dot_twin_against_dot_general(shape, integer):
    """P1's twin (and its wrapper on the CPU) against the body of the TPU
    probe's kernel, jax.lax.dot_general contracting dim 0 of both operands
    with float32 results, on the same bf16 inputs: equal on integer-valued
    inputs, within 2^-16 of the sum of |a_km b_kn| on random ones (two
    float32 summation orders)."""
    a, b = p1_cases.inputs(shape, integer)
    want = np.asarray(jax.lax.dot_general(
        jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16), (((0,), (0,)), ((), ())),
        preferred_element_type=jnp.float32))
    ta, tb = (torch.from_numpy(x).to(torch.bfloat16) for x in (a, b))
    for fn in (probe_cuda.dim0_dot_plain, probe_cuda.dim0_dot):
        got = fn(ta, tb).numpy()
        assert got.dtype == np.float32 and got.shape == want.shape == shape[1:]
        if integer:
            np.testing.assert_array_equal(got, want)
        else:
            err = np.abs(got.astype(np.float64) - want)
            assert (err <= p1_cases.tolerance(a, b)).all()
