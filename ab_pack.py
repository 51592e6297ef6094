#!/usr/bin/env python3
"""K1 (group pack) and K8 (fused VLC + pack) of one checkout of qb3_tpu_torch
on one CUDA card, and the encodes that launch them, device-resident and
host to host, for comparing two checkouts on one card.

    python3 ab_pack.py [--root DIR] [--label NAME] [--iters N]

Imports qb3_tpu_torch from DIR (default: the directory of this script) and
builds its kernels there; the inputs and the timers are chip_smoke.py's
beside this script, so two checkouts are timed by the same code.  At
chip_smoke.py's phase-3 shapes (K1 on the "ic" encode of one u8 512x512x3
tile and of 128 of them; K8 at the four wide shapes of
benchutil.WIDE_IMAGES and u64 1024x1024x1 BASE) it holds each wrapper to
its twin and prints the median between CUDA events, the device ms of
everything the wrapper issues and of its kernel alone, the device
operations a call (from a profile) and the host enqueue us.  Then the
encodes, N calls a cell, median MB/s and quartiles: device-resident (the
int64 carrier on the card to the stream words on the card: api.fast_encode
of the u8 tile and of the 128 tiles, api.fused_encode of the wide images;
each call between CUDA events) and host to host (numpy to bytes, host
clock: encode(..., index="ic") of the u8 tile, encode_tiles of the 128
tiles, encode(..., index=True) of the wide images).  The last line is one
JSON object of all of it.

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


def spread(rates) -> dict:
    q1, med, q3 = (float(v) for v in np.percentile(rates, [25, 50, 75]))
    return {"median": med, "q1": q1, "q3": q3}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=HERE, help="the checkout whose qb3_tpu_torch is timed")
    p.add_argument("--label", default="", help="a name for this checkout in the output")
    p.add_argument("--iters", type=int, default=30, help="encodes timed per cell")
    args = p.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    import qb3_tpu_torch as qt
    from qb3_tpu_torch import _build, api
    from qb3_tpu_torch.benchutil import WIDE_IMAGES, headline_image, wide_image
    from qb3_tpu_torch.constants import HILBERT
    from qb3_tpu_torch.ops import bitpack
    from qb3_tpu_torch.ops.encode_cuda import encode_pack_image, encode_pack_image_plain
    from qb3_tpu_torch.ops.pack_cuda import pack_groups_chunked

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
    result = {"label": tag, "kernels": {}, "device_encode": {}, "host_encode": {}}

    def time_kernel(name, label, fn, kernel):
        t = smoke.launch_times(fn, kernel)
        result["kernels"][f"{name} {label}"] = t
        print(f"{tag}: {name} {label}: {smoke.pack_times_text(t)} ({', '.join(t['names'])})",
              flush=True)

    for label, a in smoke.k1_cases(img, tiles, dev):
        got = pack_groups_chunked(*a)
        smoke.compare("pack_groups_chunked", got, bitpack.pack_groups(*a))
        time_kernel("K1", f"{label} {tuple(a[0].shape)}", lambda a=a: pack_groups_chunked(*a),
                    "pack_groups_kernel")
        del a, got
    for label, skipstep, x, o, a in smoke.k8_cases(dev):
        words, total, glen = encode_pack_image(*a)
        pw, pt, pg = encode_pack_image_plain(*a)
        used = (int(pt) + 31) // 32
        smoke.compare("encode_pack_image", (words[:used], total, glen), (pw[:used], pt, pg))
        time_kernel("K8", f"{label} {'FTL' if skipstep else 'BASE'}",
                    lambda a=a: encode_pack_image(*a), "encode_pack_image_kernel")
        del o, a, words, pw

    def device_cell(label, nbytes, fn):
        fn()
        torch.cuda.synchronize()
        rates = []
        for _ in range(args.iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            rates.append(nbytes / 1e6 / (start.elapsed_time(end) / 1e3))
        result["device_encode"][label] = spread(rates)
        r = result["device_encode"][label]
        print(f"{tag}: device encode {label}: median {r['median']:.2f} MB/s, quartiles "
              f"{r['q1']:.2f}-{r['q3']:.2f} ({args.iters} encodes)", flush=True)

    n_words = api.stream_words(512, 512, 3, 0)
    zero = torch.zeros(3, dtype=torch.int64, device=dev)
    zb = torch.zeros(smoke.BATCH, 3, dtype=torch.int64, device=dev)
    img_dev = api.to_carrier(img, dev)
    tiles_dev = api.to_carrier(tiles, dev)
    device_cell("ic u8 512x512x3", img.nbytes, lambda: api.fast_encode(
        img_dev, zero, zero, HILBERT, (1, 1, 1), True, 8, n_words))
    device_cell(f"ic u8 512x512x3 batch{smoke.BATCH}", tiles.nbytes, lambda: api.fast_encode(
        tiles_dev, zb, zb, HILBERT, (1, 1, 1), True, 8, n_words, lanewise=True))
    del tiles_dev
    wide = {label: wide_image(label) for label in WIDE_IMAGES}
    for label, x in wide.items():
        nb = x.shape[2]
        xd = api.to_carrier(x, dev)
        zw = torch.zeros(nb, dtype=torch.int64, device=dev)
        enc = (xd, zw, zw, HILBERT, tuple(api.default_cband(nb)), True, 8 * x.itemsize,
               smoke.n_words_for(x))
        device_cell(label, x.nbytes, lambda enc=enc: api.fused_encode(*enc))
        del xd, enc

    cells = {"ic u8 512x512x3": (img.nbytes, lambda: qt.encode(img, index="ic", device=dev)),
             f"ic u8 512x512x3 batch{smoke.BATCH}": (
                 tiles.nbytes, lambda: qt.encode_tiles(tiles, index="ic", device=dev)),
             **{label: (x.nbytes, lambda x=x: qt.encode(x, index=True, device=dev))
                for label, x in wide.items()}}
    for label, (nbytes, fn) in cells.items():
        fn()
        rates = []
        for _ in range(args.iters if "batch" not in label else max(3, args.iters // 6)):
            t0 = time.perf_counter()
            fn()
            rates.append(nbytes / 1e6 / (time.perf_counter() - t0))
        result["host_encode"][label] = r = spread(rates)
        print(f"{tag}: encode {label} host to host: median {r['median']:.2f} MB/s, quartiles "
              f"{r['q1']:.2f}-{r['q3']:.2f} ({len(rates)} encodes)", flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
