"""qb3_tpu_torch.benchutil's barrier and sustained_stats on the CPU: sync
skips host leaves, and sustained_stats gives qb3_tpu.benchutil's
(mean, sigma) under the same scripted clock."""

from collections import namedtuple
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qb3_tpu import benchutil as jbenchutil
from qb3_tpu_torch import benchutil

Plan = namedtuple("Plan", "words total")


def _tree():
    """A result tree of every kind of leaf sync meets: tensors in a
    namedtuple, a dict, lists and tuples, beside bytes, numpy arrays, ints,
    None and a plan object."""
    a, b, c = torch.arange(3), torch.zeros(2, 2), torch.ones(1, dtype=torch.uint8)
    tree = [Plan(a, 7), {"img": np.zeros((2, 2)), "parts": (b, [b"xy", None, c])},
            SimpleNamespace(t=torch.ones(1)), 3]
    return tree, [a, b, c]


def test_sync_finds_every_tensor_in_its_tree():
    tree, tensors = _tree()
    got = list(benchutil._tensors(tree))
    assert len(got) == len(tensors) and all(g is t for g, t in zip(got, tensors))


@pytest.mark.parametrize("tree", ["nested", "host only", "empty"])
def test_sync_synchronizes_nothing_for_host_leaves(tree, monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: calls.append(a))
    benchutil.sync({"nested": _tree()[0], "host only": (b"abc", np.ones(3), 4),
                    "empty": []}[tree])
    assert calls == []


def _scripted(monkeypatch, module, ticks):
    """Give module a clock that reads ticks in turn."""
    it = iter(ticks)
    monkeypatch.setattr(module, "time", SimpleNamespace(perf_counter=lambda: next(it)))


@pytest.mark.parametrize("iters,windows,seed", [(30, 3, 0), (5, 4, 1), (100, 2, 2), (1, 1, 3)])
def test_sustained_stats_is_qb3_tpus_arithmetic(iters, windows, seed, monkeypatch):
    ticks = list(np.cumsum(np.random.default_rng(seed).uniform(0.001, 0.5, 2 * windows)))
    monkeypatch.setattr(benchutil, "_require_cuda", lambda: None)
    jfn = jax.jit(lambda: jnp.arange(4.0) * 2)
    jbenchutil.sync(jfn())  # compile the function and the probe outside the script
    _scripted(monkeypatch, jbenchutil, ticks)
    want = jbenchutil.sustained_stats(jfn, iters, windows)
    calls = []
    _scripted(monkeypatch, benchutil, ticks)
    got = benchutil.sustained_stats(lambda: calls.append(1) or torch.arange(4.0) * 2,
                                    iters, windows)
    assert got == want
    assert len(calls) == 1 + iters * windows
    ts = np.diff(ticks)[::2] / iters
    assert got == (float(np.mean(ts)), float(np.std(ts) / np.mean(ts)))


def test_sustained_stats_zero_mean_gives_zero_sigma(monkeypatch):
    monkeypatch.setattr(benchutil, "_require_cuda", lambda: None)
    _scripted(monkeypatch, benchutil, [5.0] * 6)
    assert benchutil.sustained_stats(lambda: torch.zeros(1), 3, 3) == (0.0, 0.0)
    jfn = jax.jit(lambda: jnp.zeros(1))
    jbenchutil.sync(jfn())
    _scripted(monkeypatch, jbenchutil, [5.0] * 6)
    assert jbenchutil.sustained_stats(jfn, 3, 3) == (0.0, 0.0)


def test_sustained_stats_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        benchutil.sustained_stats(lambda: torch.zeros(1))
