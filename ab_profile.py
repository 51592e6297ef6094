#!/usr/bin/env python3
"""How many device records torch.profiler loses on one CUDA card, with a
bare profile and with benchutil.device_profile, in a fresh process and in
one that has idled.

    python3 ab_profile.py [--n N] [--idle SECONDS] [--iters N]

The workload is the P1 probe kernel of qb3_tpu_torch (one launch a call).
A bare profile brackets ``iters`` calls and a synchronize; what it loses is
the kernel launches the host recorded less the device kernels it holds.
device_profile launches sentinel kernels first, leaves them out and takes
a profile again when it still lacks kernels; the script counts its
profiles that needed more than one attempt and those it kept with losses.
Each of N profiles is counted in a fresh process, and again after the
process has idled for SECONDS (default 70).  The last line is one JSON
object of the counts.
"""

import argparse
import collections
import json
import sys
import time
from pathlib import Path

HERE = str(Path(__file__).resolve().parent)


def bare_lost(fn, iters: int) -> int:
    """Kernel launches less device kernels in one plain profile."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    evs = prof.events()
    kernels = sum(e.device_type == DeviceType.CUDA for e in evs)
    launches = sum(e.device_type != DeviceType.CUDA and "LaunchKernel" in e.name for e in evs)
    return launches - kernels


def count(fn, n: int, iters: int) -> dict:
    from qb3_tpu_torch.benchutil import device_profile

    bare = collections.Counter(bare_lost(fn, iters) for _ in range(n))
    retaken = kept_lossy = 0
    for _ in range(n):
        p = device_profile(fn, iters)
        retaken += p["attempts"] > 1
        kept_lossy += p["lost"] > 0
    return {"bare_lost_to_profiles": {str(k): v for k, v in sorted(bare.items())},
            "device_profile_retaken": retaken, "device_profile_kept_lossy": kept_lossy}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=30)
    ap.add_argument("--idle", type=float, default=70.0)
    ap.add_argument("--iters", type=int, default=10)
    a = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false")
        return 1
    sys.path.insert(0, HERE)
    from qb3_tpu_torch import probes

    dev = torch.device("cuda")
    kern, _ = probes.KERNELS["dim0_dot"]
    args = probes.probe_inputs("dim0_dot", dev)
    fn = lambda: kern(*args)  # noqa: E731
    fn()
    torch.cuda.synchronize()
    out = {"card": torch.cuda.get_device_name(0), "torch": torch.__version__,
           "cuda": torch.version.cuda, "n": a.n, "iters": a.iters}
    out["fresh"] = count(fn, a.n, a.iters)
    print("fresh:", out["fresh"], flush=True)
    time.sleep(a.idle)
    out[f"after {a.idle:g} s idle"] = count(fn, a.n, a.iters)
    print(f"after {a.idle:g} s idle:", out[f"after {a.idle:g} s idle"], flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
