"""Find a cell's files by name.

BENCHMARK.json (at the root of the checkout) lists the cells, the
configurations with their files and the metrics; each cell has
portbench/cells/<workload>.json (its driver and its numbers), each traffic
mix portbench/traffic/<traffic>.json (the generator's parameters), each
driver portbench/drivers/<driver>.py and each per-layer metric
portbench/metrics/<metric>.py.  A cell, a configuration, a mix or a metric
is added by adding files and entries; nothing here names one.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from dataclasses import dataclass
from types import ModuleType

HERE = os.path.dirname(os.path.abspath(__file__))


def benchmark(root: str = ".") -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _merge(base: dict, over: dict | None) -> dict:
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def workload(name: str, root: str = ".") -> dict:
    for w in benchmark(root)["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def cell(name: str, root: str = ".", overrides: dict | None = None) -> dict:
    """The cell's file with its configuration and traffic read in:
    {"name", "driver", ..., "config": {...}, "traffic": {...}};
    overrides (tests only) are merged over it."""
    w = workload(name, root)
    conf = next(c for c in benchmark(root)["configs"] if c["name"] == w["config"])
    out = _json(os.path.join(HERE, "cells", f"{name}.json"))
    out.update(name=name, config=_json(os.path.join(root, conf["file"])),
               traffic=_json(os.path.join(HERE, "traffic", f"{w['traffic']}.json")))
    return _merge(out, overrides)


def load_module(path: str, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str) -> ModuleType:
    """portbench/drivers/<name>.py."""
    return importlib.import_module(f"portbench.drivers.{name}")


def rasters(conf: dict, n: int, rng) -> "np.ndarray":
    """n tiles of the configuration's raster maker,
    portbench/rasters/<conf["raster"]>.py."""
    return importlib.import_module(f"portbench.rasters.{conf['raster']}").make(conf, n, rng)


@dataclass
class Metric:
    name: str
    unit: str
    module: ModuleType | None = None


def _applies(m: dict, w: dict, e2e: set) -> bool:
    if "workloads" in m:
        return w["name"] in m["workloads"]
    return m.get("moves") in e2e if "moves" in m else True


def end_to_end(name: str, root: str = ".") -> list[Metric]:
    w = workload(name, root)
    return [Metric(m["name"], m["unit"]) for m in benchmark(root)["end_to_end"]
            if _applies(m, w, set())]


def per_layer(name: str, root: str = ".") -> list[Metric]:
    """The cell's per-layer metrics, each with its reader loaded."""
    w = workload(name, root)
    e2e = {m.name for m in end_to_end(name, root)}
    out = []
    for m in benchmark(root)["per_layer"]:
        if _applies(m, w, e2e):
            mod = load_module(os.path.join(HERE, "metrics", f"{m['name']}.py"),
                              "portbench_metric_" + m["name"].replace(".", "_"))
            out.append(Metric(m["name"], m["unit"], mod))
    return out
