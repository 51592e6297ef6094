#!/usr/bin/env python3
"""K5a (wavefront8) and K5b (wavefront_wide), the walks on gathered
windows, of one checkout of qb3_tpu_torch on one CUDA card, and the decodes
that launch them, host to host, for comparing two checkouts on one card.

    python3 ab_wavefront.py [--root DIR] [--label NAME] [--iters N] [--kernels-only]

Imports qb3_tpu_torch from DIR (default: the directory of this script) and
builds its kernels there; the inputs and the timers are chip_smoke.py's
beside this script, so two checkouts are timed by the same code.  At every
launch shape of K5 in chip_smoke.py (the K5 branch of the "ix" decode at
the seven "ix" shapes; the best-mode kinds: the Landsat sample's walk, a
damaged u8 BASE_H walk, u32 and u64 random windows; the seven walk decodes;
a StripDecoder read of the u8 4096x4096x3 and the u16 4096x4096x1 scene;
the walk of the whole u8 scene) it holds the wrapper to its twin and
prints the median between CUDA events, the device ms of everything the
wrapper issues and of its kernel alone, the device operations a call (from
a profile) and the host enqueue us.  Then, host to host (bytes to numpy,
host clock, N calls a cell, median MB/s and quartiles): the walk decodes of
ab_walk.py's cells, the Landsat sample's decode, and the StripDecoder
decodes of both scenes in 256-row reads (none with --kernels-only).  The
last line is one JSON object of all of it.

Two versions compare only within one run of the card: run this script on
the parent and the change in turns (P C C P C P P C), each a process of its
own.
"""

import argparse
import hashlib
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


def spread(rates) -> dict:
    q1, med, q3 = (float(v) for v in np.percentile(rates, [25, 50, 75]))
    return {"median": med, "q1": q1, "q3": q3}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=HERE, help="the checkout whose qb3_tpu_torch is timed")
    p.add_argument("--label", default="", help="a name for this checkout in the output")
    p.add_argument("--iters", type=int, default=20, help="decodes timed per cell")
    p.add_argument("--kernels-only", action="store_true", help="time the kernels, no decodes")
    args = p.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    import qb3_tpu_torch as qt
    from qb3_tpu_torch import _build, batch
    from qb3_tpu_torch.benchutil import (LANDSAT_SAMPLE, LANDSAT_SHA256, WIDE_IMAGES,
                                         headline_image, wide_image)
    from qb3_tpu_torch.constants import Mode

    if not os.path.abspath(qt.__file__).startswith(root + os.sep):
        print(f"FAIL: qb3_tpu_torch imported from {qt.__file__}, not {root}", file=sys.stderr)
        return 1
    smoke = load_smoke()
    _build.build()
    _build.load()
    dev = torch.device("cuda")
    tag = args.label or root
    print(f"{tag}: {smoke.card_line()}", flush=True)
    result = {"label": tag, "kernels": {}, "host_decode": {}}

    def shapes():
        for label, tiles in smoke.ix_cases().items():
            yield f"ix {label}", smoke.k5_ix_case(batch.encode_tiles(tiles, index=True,
                                                                     device=dev), dev)
        for label, case, _ in smoke.k5_decode_cases(dev):
            yield label, case

    for label, case in shapes():
        name, kern, plain = smoke.k5_kernel(case["tbits"])
        kargs = smoke.k5_args(case)
        smoke.compare(f"{name} {label}", kern(*kargs), plain(*kargs))
        t = smoke.launch_times(lambda kargs=kargs: kern(*kargs), f"{name}_kernel")
        key = f"{name} {label}"
        result["kernels"][key] = dict(t, groups=case["kind"].numel(), nreg=case["nreg"])
        print(f"{tag}: {key}, {case['kind'].numel()} groups, nreg {case['nreg']}: "
              f"{smoke.pack_times_text(t)} ({', '.join(t['names'])})", flush=True)
        del case, kargs
    if args.kernels_only:
        print(json.dumps(result), flush=True)
        return 0

    img = headline_image()
    nodata = img.copy()
    nodata[64:320, 96:448] = 0  # as chip_smoke.walk_phase's
    cells = {"u8 512x512x3 FTL": (img, Mode.FTL), "u8 512x512x3 BASE_Z": (img, Mode.BASE_Z),
             "u8 512x512x3 no-data RLE_H": (nodata, Mode.RLE_H),
             **{label: (wide_image(label), Mode.FTL) for label in WIDE_IMAGES}}
    decodes = {}
    for label, (x, mode) in cells.items():
        s = qt.encode(x, mode=mode, device=dev)
        decodes[f"walk {label}"] = (x, lambda s=s: qt.decode(s, device=dev)[0], args.iters)
    with open(os.path.join(HERE, LANDSAT_SAMPLE), "rb") as f:
        landsat = f.read()
    out = qt.decode(landsat, device=dev)[0]
    if hashlib.sha256(out.tobytes()).hexdigest() != LANDSAT_SHA256:
        print(f"FAIL: {tag} Landsat sample: the decode differs from its pin", file=sys.stderr)
        return 1
    decodes["walk Landsat 512x512x8 u16 CF_H"] = (
        out, lambda: qt.decode(landsat, device=dev)[0], args.iters)
    for label, (x, mode, indexes) in smoke.strip_cases().items():
        s = qt.encode(x, mode=mode, index=indexes[0], device=dev)
        side = {False: "no sidecar", True: "ix"}.get(indexes[0], indexes[0])
        decodes[f"strips {label} {side}"] = (
            x, lambda s=s: smoke.strip_decode(s, dev)[0], max(3, args.iters // 4))
    for label, (want, fn, iters) in decodes.items():
        if not np.array_equal(np.asarray(fn()).reshape(want.shape), want):
            print(f"FAIL: {tag} {label}: the decode differs", file=sys.stderr)
            return 1
        rates = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            rates.append(want.nbytes / 1e6 / (time.perf_counter() - t0))
        result["host_decode"][label] = r = spread(rates)
        print(f"{tag}: decode {label} host to host: median {r['median']:.2f} MB/s, quartiles "
              f"{r['q1']:.2f}-{r['q3']:.2f} ({iters} decodes)", flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
