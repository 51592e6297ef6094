#!/usr/bin/env python3
"""K3 (window copy) and K7 (window gather) of one checkout of qb3_tpu_torch
on one CUDA card, beside torch.take on the same windows, and the decodes
that launch them host to host, for comparing two checkouts on one card.

    python3 ab_gather.py [--root DIR] [--label NAME] [--iters N]

Imports qb3_tpu_torch from DIR (default: the directory of this script) and
builds its kernels there; the inputs, the torch.take yardstick and the
timers are chip_smoke.py's beside this script, so two checkouts are timed
by the same code.  At chip_smoke.py's phase-3 shapes (K3 on the "ic" decode
of one u8 512x512x3 tile, 128 of them and a u16 1024x1024x1 raster; K7 on
the walk decode of the u8 tile and of u64 1024x1024x1) it holds the kernel
to torch.take and prints, for both, the median between CUDA events, the
device ms from a profile and the host enqueue us.  Then it times the cost
of the current stream as a Python object and as PyTorch's raw handle and
of one torch.empty, and the decodes host to host (the "ic" decode of the u8 tile, the walk decode
of it and of the four wide images of benchutil.WIDE_IMAGES): N single
decodes a cell on the host clock, their median MB/s and quartiles.  The
last line is one JSON object of all of it.

Two versions compare only within one run of the card: run this script on
the parent and the change in turns (parent, change, change, parent), each a
process of its own.
"""

import argparse
import importlib.util
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def load_smoke():
    """chip_smoke.py beside this script, as a module."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def host_us(dev, iters: int = 20000) -> dict:
    """Host us per call of what a wrapper pays besides its checks and the
    launch: the current stream's handle through a Python Stream object and
    through PyTorch's raw-stream call, and torch.empty of one u8 tile's K3
    output."""
    import torch

    out, index = {}, torch.cuda.current_device()
    for name, fn in (("current_stream().cuda_stream",
                      lambda: torch.cuda.current_stream(dev).cuda_stream),
                     ("_cuda_getCurrentRawStream", lambda: torch._C._cuda_getCurrentRawStream(
                         index)),
                     ("torch.empty(16, 7168)", lambda: torch.empty(16, 7168, dtype=torch.int32,
                                                                   device=dev))):
        fn()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        out[name] = (time.perf_counter() - t0) / iters * 1e6
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=HERE, help="the checkout whose qb3_tpu_torch is timed")
    p.add_argument("--label", default="", help="a name for this checkout in the output")
    p.add_argument("--iters", type=int, default=30, help="decodes timed per cell")
    args = p.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    import qb3_tpu_torch as qt
    from qb3_tpu_torch import _build
    from qb3_tpu_torch.benchutil import WIDE_IMAGES, headline_image, wide_image
    from qb3_tpu_torch.ops.gather_cuda import gather_slabs
    from qb3_tpu_torch.ops.pack_cuda import extract_windows

    if not os.path.abspath(qt.__file__).startswith(root + os.sep):
        print(f"FAIL: qb3_tpu_torch imported from {qt.__file__}, not {root}", file=sys.stderr)
        return 1
    smoke = load_smoke()
    _build.build()
    _build.load()
    dev = torch.device("cuda")
    tag = args.label or root
    img = headline_image()
    tiles = np.stack([headline_image(seed=100 + i) for i in range(smoke.BATCH)])
    u16 = headline_image(1024, 1024, 1, seed=7, dtype=np.uint16)
    result = {"label": tag, "kernels": {}, "host_us": host_us(dev), "decode": {}}

    def time_both(name, label, fn, op, take):
        smoke.compare(name, fn(), take())
        t = {"kernel": smoke.launch_times(fn, op), "torch.take": smoke.launch_times(take)}
        result["kernels"][f"{name} {label}"] = t
        print(f"{tag}: {name} {label}: kernel {smoke.times_text(t['kernel'])}; torch.take "
              f"{smoke.times_text(t['torch.take'])}", flush=True)

    for label, streams, _ in smoke.k3_cases(img, tiles, u16, dev):
        a = smoke.walk_inputs(streams, dev)
        w = (a["words32"], a["wrow"], a["R"])
        time_both("K3", f"{label} {tuple(a['wrow'].shape)} x {a['R']}",
                  lambda w=w: extract_windows(*w), "extract_windows_kernel",
                  smoke.take_windows(w[0], w[1].to(torch.int64) * 128, w[2]))
        del a, w
    for label, x in (("u8 512x512x3", img), ("u64 1024x1024x1", wide_image("u64 1024x1024x1"))):
        a = smoke.k7_inputs(x, dev)
        g = (a["words32"], a["base"], a["nreg"], a["R"])
        time_both("K7", f"{label} {tuple(g[1].shape)} x {g[2]}",
                  lambda g=g: gather_slabs(*g), "gather_slabs_kernel",
                  smoke.take_windows(g[0], g[1], g[2]))
    print(f"{tag}: host us a call: " + ", ".join(
        f"{k} {v:.3f}" for k, v in result["host_us"].items()), flush=True)

    cells = {"ic u8 512x512x3": (img, dict(index="ic")), "walk u8 512x512x3": (img, {}),
             **{f"walk {label}": (wide_image(label), {}) for label in WIDE_IMAGES}}
    for label, (x, kw) in cells.items():
        s = qt.encode(x, device=dev, **kw)
        if not np.array_equal(qt.decode(s, device=dev)[0], x):
            print(f"FAIL: {tag} {label}: the decode differs", file=sys.stderr)
            return 1
        rates = []
        for _ in range(args.iters):
            t0 = time.perf_counter()
            qt.decode(s, device=dev)
            rates.append(x.nbytes / 1e6 / (time.perf_counter() - t0))
        q1, med, q3 = (float(v) for v in np.percentile(rates, [25, 50, 75]))
        result["decode"][label] = {"median": med, "q1": q1, "q3": q3}
        print(f"{tag}: decode {label} host to host: median {med:.2f} MB/s, quartiles "
              f"{q1:.2f}-{q3:.2f} ({args.iters} decodes)", flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
