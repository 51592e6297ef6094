"""qb3 command line converter on PyTorch — the cqb3/dqb3 equivalent (cqb3.cpp).

    python -m qb3_tpu_torch.cli image.png            # -> image.qb3 (FTL)
    python -m qb3_tpu_torch.cli -b image.png         # best mode
    python -m qb3_tpu_torch.cli -q 4 image.png       # lossy quanta (use +4
                                                     #  to round away from zero)
    python -m qb3_tpu_torch.cli -d image.qb3 out.png # decode
    python -m qb3_tpu_torch.cli folder/              # batch convert *.png / *.qb3
    python -m qb3_tpu_torch.cli --device cpu x.png   # on the CPU (default: cuda)

The counterpart of qb3_tpu/cli.py on the port's encode and decode, writing
the same files.  Mirrors the reference tool's options (cqb3.cpp:68-88): -v
verbose, -b best, -f fast (FTL, default), -l legacy z-curve, -r RLE, -q
quanta, -t trim to a multiple of 4, -m x band-mix search, plus --index for
the parallel-decode sidecar, --device for the device the codec runs on and
--trace DIR for a torch.profiler trace of the run (profiling.trace).
Prints MB/s the way the reference tools do (cqb3.cpp:325-327).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import contextlib

import numpy as np
import torch

from . import api
from .constants import Mode


def _load_image(path: str) -> np.ndarray:
    """8- and 16-bit PNG (incl. 16-bit multichannel, pngio.py); other
    formats via Pillow; .npy for the wider integer types."""
    if path.lower().endswith(".npy"):
        arr = np.load(path)
    elif path.lower().endswith(".png"):
        from . import pngio

        arr = pngio.read_png(path)
    else:
        from PIL import Image

        arr = np.asarray(Image.open(path))
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr


def _save_image(path: str, arr: np.ndarray):
    if arr.dtype in (np.uint8, np.uint16) and path.lower().endswith(".png"):
        from . import pngio

        pngio.write_png(path, arr)
        return path
    # PNG can't carry 32/64-bit or signed rasters; fall back to .npy
    alt = os.path.splitext(path)[0] + ".npy"
    np.save(alt, arr)
    return alt


def pick_mode(args) -> Mode:
    if args.best and args.rle:
        return Mode.CF_RLE_H
    if args.best:
        return Mode.CF_H
    if args.legacy:
        return Mode.CF_RLE if args.rle else Mode.BASE_Z
    if args.rle:
        return Mode.RLE_H
    return Mode.BASE_H if args.base else Mode.FTL


BANDMIXES = [  # RGB core-band trials (cqb3.cpp:561-586)
    [0, 1, 2], [1, 1, 1], [0, 0, 0], [2, 2, 2],
    [0, 0, 2], [0, 1, 1], [0, 1, 0], [1, 1, 2], [2, 1, 2], [0, 2, 2],
]


def encode_one(path: str, out: str, args) -> int:
    img = _load_image(path)
    if args.trim:
        img = img[: img.shape[0] // 4 * 4, : img.shape[1] // 4 * 4]
    quanta, away = 1, False
    if args.quanta:
        away = args.quanta.startswith("+")
        quanta = int(args.quanta.lstrip("+"))
    mode = pick_mode(args)
    t0 = time.perf_counter()
    if args.bandmix and img.shape[2] == 3:
        best = None
        for mix in BANDMIXES:
            s = api.encode(img, mode=mode, quanta=quanta, away=away,
                           coreband=mix, index=args.index, device=args.device)
            if best is None or len(s) < len(best[0]):
                best = (s, mix)
        stream, mix = best
        if args.verbose:
            print(f"  band mix {mix}")
    else:
        stream = api.encode(img, mode=mode, quanta=quanta, away=away,
                            index=args.index, device=args.device)
    dt = time.perf_counter() - t0
    with open(out, "wb") as f:
        f.write(stream)
    if args.verbose:
        mb = img.nbytes / 1e6
        print(f"{path}: {img.nbytes} -> {len(stream)} bytes "
              f"({100 * len(stream) / img.nbytes:.2f}%), {mb / dt:.1f} MB/s, "
              f"mode {mode.name}, quanta {quanta}")
    return 0


def decode_one(path: str, out: str, args) -> int:
    with open(path, "rb") as f:
        stream = f.read()
    t0 = time.perf_counter()
    img, info = api.decode(stream, device=args.device)
    dt = time.perf_counter() - t0
    out = _save_image(out, img)
    if args.verbose:
        print(f"{path}: {len(stream)} -> {img.nbytes} bytes ({out}), "
              f"{img.nbytes / 1e6 / dt:.1f} MB/s, mode {Mode(info.mode).name}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="qb3-torch", description=__doc__.split("\n")[0])
    ap.add_argument("input")
    ap.add_argument("output", nargs="?")
    ap.add_argument("-d", "--decode", action="store_true", help="force decode")
    ap.add_argument("-v", "--verbose", action="store_true")
    ap.add_argument("-b", "--best", action="store_true", help="best compression")
    ap.add_argument("-f", "--fast", action="store_true", help="FTL mode (default)")
    ap.add_argument("--base", action="store_true", help="Hilbert base mode")
    ap.add_argument("-l", "--legacy", action="store_true", help="legacy z-curve")
    ap.add_argument("-r", "--rle", action="store_true", help="RLE0 post-pass")
    ap.add_argument("-q", "--quanta", help="lossy quanta n (or +n: round away)")
    ap.add_argument("-t", "--trim", action="store_true", help="trim dims to multiple of 4")
    ap.add_argument("-m", "--bandmix", action="store_true",
                    help="search RGB band mixes for the smallest output")
    ap.add_argument("--index", action="store_true",
                    help="embed the parallel-decode sidecar chunk")
    ap.add_argument("--trace", metavar="DIR",
                    help="capture a torch.profiler trace into DIR")
    ap.add_argument("--device", default="cuda",
                    help="the device the codec runs on (default: cuda)")
    args = ap.parse_args(argv)

    with contextlib.ExitStack() as stack:
        if args.trace:
            from . import profiling

            if torch.device(args.device).type == "cuda":
                torch.cuda.init()  # so that the trace records the device
            stack.enter_context(profiling.trace(args.trace))
        return _run(args)


def _run(args) -> int:
    if os.path.isdir(args.input):
        n = 0
        for name in sorted(os.listdir(args.input)):
            p = os.path.join(args.input, name)
            low = name.lower()
            if low.endswith(".qb3"):
                decode_one(p, p[:-4] + ".png", args)
                n += 1
            elif low.endswith((".png", ".jpg", ".jpeg", ".npy")):
                encode_one(p, os.path.splitext(p)[0] + ".qb3", args)
                n += 1
        if args.verbose:
            print(f"{n} files")
        return 0

    is_decode = args.decode or args.input.lower().endswith(".qb3")
    if is_decode:
        out = args.output or os.path.splitext(args.input)[0] + ".png"
        return decode_one(args.input, out, args)
    out = args.output or os.path.splitext(args.input)[0] + ".qb3"
    return encode_one(args.input, out, args)


if __name__ == "__main__":
    sys.exit(main())
