#!/usr/bin/env python3
"""The decode without a sidecar, host to host, of one checkout of
qb3_tpu_torch on one CUDA card, for comparing two checkouts on one host.

    python3 ab_walk.py [--root DIR] [--label NAME] [--iters N]

Imports qb3_tpu_torch from DIR (default: the directory of this script) and
builds its kernels there.  For each walk cell of chip_smoke.py's phase 5 (a
512x512x3 u8 tile in FTL, BASE_Z and RLE_H with a no-data rectangle, and
the four wide images of benchutil.WIDE_IMAGES in FTL), it encodes the image
without a sidecar, holds the decode to the image, and prints one line: the
host-to-host decode MB/s (the mean of N calls on the host clock) and, from a
device profile of the decode, the device ms of K7 and K5 and the device's
busy ms and idle share.  The repository's Landsat sample (512x512x8 u16
CF_H) follows where the checkout decodes best-mode streams.  The last line
is one JSON object of the MB/s by cell.

Two versions compare only within one run of the card: run this script on
the parent and the change in turns (parent, change, change, parent), each a
process of its own.
"""

import argparse
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
LANDSAT = os.path.join(HERE, "web", "sample_landsat8.qb3")


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=HERE, help="the checkout whose qb3_tpu_torch is timed")
    p.add_argument("--label", default="", help="a name for this checkout in the output")
    p.add_argument("--iters", type=int, default=20, help="decodes timed per cell")
    args = p.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    import qb3_tpu_torch as qt
    from qb3_tpu_torch import _build
    from qb3_tpu_torch.benchutil import (WIDE_IMAGES, device_profile, headline_image,
                                         host_seconds, wide_image)
    from qb3_tpu_torch.constants import Mode

    if not os.path.abspath(qt.__file__).startswith(root + os.sep):
        print(f"FAIL: qb3_tpu_torch imported from {qt.__file__}, not {root}", file=sys.stderr)
        return 1
    _build.build()
    _build.load()
    dev = torch.device("cuda")
    tag = args.label or root
    img = headline_image()
    nodata = img.copy()
    nodata[64:320, 96:448] = 0
    cells = {"u8 512x512x3 FTL": (img, Mode.FTL), "u8 512x512x3 BASE_Z": (img, Mode.BASE_Z),
             "u8 512x512x3 no-data RLE_H": (nodata, Mode.RLE_H),
             **{label: (wide_image(label), Mode.FTL) for label in WIDE_IMAGES}}
    streams = {label: (qt.encode(x, mode=mode, device=dev), x)
               for label, (x, mode) in cells.items()}
    with open(LANDSAT, "rb") as f:
        landsat = f.read()
    try:
        streams["Landsat 512x512x8 u16 CF_H"] = (landsat, qt.decode(landsat, device=dev)[0])
    except NotImplementedError:
        print(f"{tag}: Landsat sample not decoded by this checkout (best mode)", flush=True)
    rates = {}
    for label, (s, x) in streams.items():
        d = qt.Decoder(s, device=dev)
        if not np.array_equal(d.read_data(), x):
            print(f"FAIL: {tag} {label}: the decode differs", file=sys.stderr)
            return 1
        t = host_seconds(lambda s=s: qt.decode(s, device=dev), args.iters)
        prof = device_profile(lambda s=s: qt.decode(s, device=dev))
        k7, k5 = (sum(v for op, v in prof["per_op"].items() if k in op)
                  for k in ("gather_slabs_kernel", "wavefront"))
        rates[label] = x.nbytes / 1e6 / t
        print(f"{tag}: walk decode {label} ({d.decode_path}), host to host "
              f"{rates[label]:.2f} MB/s, {t * 1e3:.4f} ms; device K7 {k7:.4f} ms, K5 "
              f"{k5:.4f} ms, busy {prof['busy_ms']:.4f} ms, idle {prof['idle']:.3f}",
              flush=True)
    print(json.dumps({"label": tag, "mb_per_s": rates}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
