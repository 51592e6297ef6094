#!/usr/bin/env python3
"""K2 (the "ic" chunk walk) and K4 (the fused "ix" walk) of one checkout of
qb3_tpu_torch on one CUDA card, and the decodes that launch them,
device-resident and host to host, for comparing two checkouts on one card.

    python3 ab_decode.py [--root DIR] [--label NAME] [--iters N]

Imports qb3_tpu_torch from DIR (default: the directory of this script) and
builds its kernels there; the inputs and the timers are chip_smoke.py's
beside this script, so two checkouts are timed by the same code.  At every
launch shape of chip_smoke.py's phase 3 (K2 on the "ic" decode of one u8
512x512x3 tile, of 128 of them and of a u16 1024x1024x1 raster; K4 at the
seven "ix" shapes, parsing the codeswitches as the decode does and with the
rungs given) it holds each wrapper to its twin and prints the median
between CUDA events, the device ms of everything the wrapper issues and of
its kernel alone, the device operations a call (from a profile) and the
host enqueue us.  Then the "ic" and "ix" decodes of one u8 tile and of 128,
N calls a cell, median MB/s and quartiles: device-resident (stream words
and sidecar on the card to the raster on the card, each call between CUDA
events) and host to host (bytes to numpy, host clock: decode of the tile,
decode_tiles of the 128).  The last line is one JSON object of all of it.

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
    p.add_argument("--iters", type=int, default=30, help="decodes timed per cell")
    args = p.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    import qb3_tpu_torch as qt
    from qb3_tpu_torch import _build, api, batch
    from qb3_tpu_torch.benchutil import headline_image
    from qb3_tpu_torch.constants import HILBERT
    from qb3_tpu_torch.ops.chunkwalk_cuda import chunkwalk8, chunkwalk8_plain
    from qb3_tpu_torch.ops.decode import (decode_indexed_narrow, ix_parse, ix_regs, reconstruct,
                                          reconstruct_batch)
    from qb3_tpu_torch.ops.decode_chunked import decode_chunked_auto
    from qb3_tpu_torch.ops.fusedwin_cuda import wavefront_fused, wavefront_fused_plain
    from qb3_tpu_torch.ops.pack_cuda import extract_windows

    if not os.path.abspath(qt.__file__).startswith(root + os.sep):
        print(f"FAIL: qb3_tpu_torch imported from {qt.__file__}, not {root}", file=sys.stderr)
        return 1
    smoke = load_smoke()
    _build.build()
    _build.load()
    dev = torch.device("cuda")
    tag = args.label or root
    print(f"{tag}: {smoke.card_line()}", flush=True)
    img = headline_image()
    tiles = np.stack([headline_image(seed=100 + i) for i in range(smoke.BATCH)])
    u16 = headline_image(1024, 1024, 1, seed=7, dtype=np.uint16)
    result = {"label": tag, "kernels": {}, "device_decode": {}, "host_decode": {}}

    def time_kernel(name, label, fn, kernel):
        t = smoke.launch_times(fn, kernel)
        result["kernels"][f"{name} {label}"] = t
        print(f"{tag}: {name} {label}: {smoke.pack_times_text(t)} ({', '.join(t['names'])})",
              flush=True)

    ic_streams = {}
    for label, streams, ubits in smoke.k3_cases(img, tiles, u16, dev):
        ic_streams[label] = streams
        a = smoke.walk_inputs(streams, dev)
        win = extract_windows(a["words32"], a["wrow"], a["R"])
        cargs = (a["words32"], win, a["wrow"], a["starts"], a["entry"], a["k"], a["nb"], False,
                 ubits)
        smoke.compare("chunkwalk8", chunkwalk8(*cargs), chunkwalk8_plain(*cargs))
        time_kernel("K2", f"{label} chunks {a['starts'].numel()}",
                    lambda cargs=cargs: chunkwalk8(*cargs), "chunkwalk")
        del a, win, cargs

    ix_streams = {}
    for label, x in smoke.ix_cases().items():
        streams = batch.encode_tiles(x, index=True, device=dev)
        if x.dtype == np.uint8:
            ix_streams[label] = streams
        a = smoke.ix_inputs(streams, dev)
        tb, nreg = a["tbits"], a["nreg"]
        k4 = (a["words32"], a["goff"], nreg, a["R"], tb)
        kw = dict(nbands=a["nb"], per_tile=a["per_tile"])
        smoke.compare("wavefront_fused", wavefront_fused(*k4, **kw),
                      wavefront_fused_plain(*k4[:3], tb, **kw))
        time_kernel("K4", f"{label} groups {a['goff'].numel()}",
                    lambda k4=k4, kw=kw: wavefront_fused(*k4, **kw), "fused_kernel")
        regs = ix_regs(a["words32"], a["goff"], nreg)
        given = dict(zip(("off", "rung", "kind"), (
            v.to(torch.int32) for v in ix_parse(regs, a["goff"], tb, a["nb"], a["per_tile"]))))
        del regs
        smoke.compare("wavefront_fused", wavefront_fused(*k4, **given),
                      wavefront_fused_plain(*k4[:3], tb, **given))
        time_kernel("K4 given rungs", label,
                    lambda k4=k4, given=given: wavefront_fused(*k4, **given), "fused_kernel")
        del a, k4, given

    def device_cell(label, nbytes, fn, want):
        if not torch.equal(fn().cpu().reshape(want.shape), torch.from_numpy(want)):
            raise SystemExit(f"FAIL: {tag} {label}: the device decode differs")
        torch.cuda.synchronize()
        rates = []
        for _ in range(args.iters if "batch" not in label else max(3, args.iters // 3)):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            rates.append(nbytes / 1e6 / (start.elapsed_time(end) / 1e3))
        result["device_decode"][label] = r = spread(rates)
        print(f"{tag}: device decode {label}: median {r['median']:.2f} MB/s, quartiles "
              f"{r['q1']:.2f}-{r['q3']:.2f} ({len(rates)} decodes)", flush=True)

    a1 = smoke.walk_inputs(ic_streams["single u8"], dev)
    ab = smoke.walk_inputs(ic_streams[f"batch{smoke.BATCH} u8"], dev)
    device_cell("ic u8 512x512x3", img.nbytes, lambda: api.ic_decode(
        a1, a1["nblocks"], 3, 512, 512, HILBERT, a1["cband"], False, 8).to(torch.uint8), img)

    def ic_batch():
        nch = -(-ab["nblocks"] // ab["k"])
        g = decode_chunked_auto(ab["words32"], ab["starts"], ab["entry"], ab["k"],
                                smoke.BATCH * nch * ab["k"], 3, False, 8, ab["maxw"], ab["R"])
        g = g.reshape(smoke.BATCH, nch * ab["k"], 3, 16)[:, :ab["nblocks"]]
        return reconstruct_batch(g, 512, 512, 3, HILBERT, ab["cband"], 8).to(torch.uint8)

    device_cell(f"ic u8 512x512x3 batch{smoke.BATCH}", tiles.nbytes, ic_batch, tiles)

    for label, want in (("u8 512x512x3", img), (f"u8 512x512x3 batch{smoke.BATCH}", tiles)):
        a = smoke.ix_inputs(ix_streams[label], dev)

        def ix_dec(a=a):
            n = a["ntiles"]
            g = decode_indexed_narrow(a["words32"], a["glens"], a["nblocks"], 3, False, 8, n,
                                      a["tw32"], a["nreg"], fused=a["R"])
            if n == 1:
                zero = torch.zeros(3, dtype=torch.int64, device=dev)
                out, _ = reconstruct(g.reshape(a["nblocks"], 3, 16), zero, a["h"], a["w"], 3,
                                     HILBERT, a["cband"], 8)
            else:
                out = reconstruct_batch(g.reshape(n, a["nblocks"], 3, 16), a["h"], a["w"], 3,
                                        HILBERT, a["cband"], 8)
            return out.to(torch.uint8)

        device_cell(f"ix {label}", want.nbytes, ix_dec, want)
        del a

    cells = {"ic u8 512x512x3": (img, lambda: qt.decode(ic_streams["single u8"][0],
                                                         device=dev)[0]),
             f"ic u8 512x512x3 batch{smoke.BATCH}": (tiles, lambda: qt.decode_tiles(
                 ic_streams[f"batch{smoke.BATCH} u8"], device=dev)),
             "ix u8 512x512x3": (img, lambda: qt.decode(ix_streams["u8 512x512x3"][0],
                                                         device=dev)[0]),
             f"ix u8 512x512x3 batch{smoke.BATCH}": (tiles, lambda: qt.decode_tiles(
                 ix_streams[f"u8 512x512x3 batch{smoke.BATCH}"], device=dev))}
    for label, (want, fn) in cells.items():
        if not np.array_equal(np.asarray(fn()).reshape(want.shape), want):
            raise SystemExit(f"FAIL: {tag} {label}: the decode differs")
        rates = []
        for _ in range(args.iters if "batch" not in label else max(3, args.iters // 6)):
            t0 = time.perf_counter()
            fn()
            rates.append(want.nbytes / 1e6 / (time.perf_counter() - t0))
        result["host_decode"][label] = r = spread(rates)
        print(f"{tag}: decode {label} host to host: median {r['median']:.2f} MB/s, quartiles "
              f"{r['q1']:.2f}-{r['q3']:.2f} ({len(rates)} decodes)", flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
