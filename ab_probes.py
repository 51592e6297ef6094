#!/usr/bin/env python3
"""P1 (the dim-0 contraction Aᵀ·B) and the kernels not yet redesigned (K6,
P2-P7) of one checkout of qb3_tpu_torch on one CUDA card, each beside a
PyTorch call and the launch floor, for comparing two checkouts on one card.

    python3 ab_probes.py [--root DIR] [--label NAME]

Imports qb3_tpu_torch from DIR (default: the directory of this script) and
builds its kernels there; the inputs, comparators and timers are
chip_smoke.py's beside this script, so two checkouts are timed by the same
code.

It prints the card; P1's resources (ptxas: registers, shared memory, stack,
spills; cuobjdump: its HGMMA and FFMA instructions); the launch floor (an
empty kernel's device ms, where the checkout has one); then, kernel and
comparator in turns (K C C K), P1 at the probe's shape beside
torch.mm(a.T, b, out_dtype=torch.float32), P2-P7 at their probes' shapes
beside chip_smoke.probe_comparator's calls, and K6 at the slabs of the u8
4096x4096x3 strip stitch beside index_add_: the median between CUDA events, the device ms of the kernel and of everything a call
issues, the device operations a call and the host enqueue us
(chip_smoke.launch_times).  The last line is one JSON object of all of it.

Two versions compare only within one run of the card: run this script on
the parent and the change in turns (P C C P C P P C), each a process of its
own.
"""

import argparse
import importlib.util
import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
# the probes' kernels by name in a profile
KERNEL_NAMES = {"dim0_dot": "dim0_dot_kernel", "1d_dma": "dma_1d_kernel",
                "flatten": "flatten_kernel", "3d_dma": "dma_3d_kernel",
                "lane_write": "lane_write_kernel", "lane_concat": "lane_concat_kernel",
                "flatten_big": "flatten_kernel"}


def load_smoke():
    """chip_smoke.py beside this script, as a module."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def resources(lib: str) -> dict:
    """P1's kernel in the library: ptxas's report (from the build log) and
    the count of HGMMA and FFMA instructions in its SASS."""
    out = {}
    lines = open(lib + ".log").read().splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and "dim0_dot" in line:
            out["ptxas"] = " | ".join(x.strip() for x in lines[i + 2:i + 4])
            break
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", lib], capture_output=True, text=True).stdout
    for part in sass.split("Function : ")[1:]:
        if "dim0_dot" in part.split("\n", 1)[0]:
            out.update(hgmma=part.count("HGMMA"), ffma=part.count("FFMA"),
                       local=part.count("LDL") + part.count("STL"))
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=HERE, help="the checkout whose qb3_tpu_torch is timed")
    p.add_argument("--label", default="", help="a name for this checkout in the output")
    args = p.parse_args()
    root = os.path.abspath(args.root)
    tag = args.label or root
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    import qb3_tpu_torch as qt
    from qb3_tpu_torch import _build, probes
    from qb3_tpu_torch.ops import probe_cuda

    if not os.path.abspath(qt.__file__).startswith(root + os.sep):
        print(f"FAIL: qb3_tpu_torch imported from {qt.__file__}, not {root}", file=sys.stderr)
        return 1
    smoke = load_smoke()
    lib = _build.build()
    _build.load()
    dev = torch.device("cuda")
    print(f"{tag}: {smoke.card_line()}", flush=True)
    result = {"label": tag, "p1_resources": resources(lib), "kernels": {}}
    print(f"{tag}: P1 resources {result['p1_resources']}", flush=True)
    if hasattr(probe_cuda, "empty"):
        t = smoke.launch_times(lambda: probe_cuda.empty(dev), "empty_kernel")
        result["floor"] = t
        print(f"{tag}: launch floor (empty kernel): {smoke.pack_times_text(t)}", flush=True)

    def cases():
        for name in probes.PROBES:
            kern, plain = probes.KERNELS[name]
            pargs = probes.probe_inputs(name, dev)
            got = kern(*pargs)
            comp = smoke.probe_comparator(name, pargs)
            smoke.compare(name, got, plain(*pargs))
            smoke.compare(name, comp(), got)
            yield f"probe_{name}", lambda k=kern, a=pargs: k(*a), KERNEL_NAMES[name], comp
        slab, base, n_out = smoke.k6_inputs(dev, smoke.strip_cases()["u8 4096x4096x3 FTL"][0])
        fn, comp = smoke.k6_calls(slab, base, n_out)
        smoke.compare("place_slabs", fn(), comp())
        yield "place_slabs", fn, "place_slabs_kernel", comp

    for key, fn, kname, comp in cases():
        runs = {"kernel": [], "comparator": []}
        for who in ("kernel", "comparator", "comparator", "kernel"):
            t = (smoke.launch_times(fn, kname) if who == "kernel"
                 else smoke.launch_times(comp))
            runs[who].append(t)
        result["kernels"][key] = runs
        for who, ts in runs.items():
            print(f"{tag}: {key} {who}: " + " / ".join(smoke.pack_times_text(t) for t in ts),
                  flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
