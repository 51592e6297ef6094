#!/usr/bin/env python3
"""Per-block phase times of K1 (group pack) and K8 (fused VLC + pack) on one
CUDA card, from a copy of qb3_tpu_torch with time stamps in the two kernels.

    python3 ab_phases.py [--set NAME=VALUE ...] [--label NAME]

Copies this checkout's qb3_tpu_torch into ab/phases-<label>/ (git-ignored),
sets the named constants of csrc/blockpack.cuh there (for example
--set kParts=1 to time one thread a group), and has thread 0 of every block
of both kernels record the card's %globaltimer at entry, after its ticket,
after the staging, after the block scan, after its placement, after its
look-back (warp 0's), after the last barrier and after the store.
The copy builds its own kernels.  At chip_smoke.py's phase-3 shapes (K1 on
one u8 512x512x3 tile and 128 of them; K8 at the four wide shapes and u64
BASE) it prints each call's device ms (a profile, as chip_smoke.py's
launch_times takes it; the stamps cost a few stores a block) and, over the
blocks of one call after a warm-up, the median, 90th percentile and largest
time of each phase, the spread of the blocks' starts (waves) and the
phases of the block that finished last.
"""

import argparse
import ctypes
import importlib.util
import os
import re
import shutil
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
PHASES = ("ticket", "stage", "scan", "place", "look-back", "barrier", "store")
STAMPS = """__device__ unsigned long long g_stamp[1 << 20];  // block b, point k at 8 * b + k
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define STAMP_IF(c, k) if ((c) && vb < (1 << 17)) qb3::g_stamp[vb * 8 + (k)] = qb3::gtime();
#define STAMP(k) STAMP_IF(threadIdx.x == 0, k)
"""


def instrument(dst: str, settings: list[str]):
    """Copy the package to dst and put the stamps into its two kernels."""
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(HERE, "qb3_tpu_torch"), os.path.join(dst, "qb3_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    csrc = os.path.join(dst, "qb3_tpu_torch", "csrc")
    path = os.path.join(csrc, "blockpack.cuh")
    src = open(path).read()
    for kv in settings:
        name, value = kv.split("=")
        src, n = re.subn(rf"constexpr (int|bool) {name} = \w+;", rf"constexpr \1 {name} = {value};",
                         src)
        if n != 1:
            raise SystemExit(f"no constant {name} in csrc/blockpack.cuh")
    open(path, "w").write(src.replace("namespace qb3 {", "namespace qb3 {\n" + STAMPS, 1))
    for name, tag, kernel in (("pack.cu", "k1", "pack_groups_kernel("),
                              ("encode_image.cu", "k8", "encode_pack_image_kernel(")):
        path = os.path.join(csrc, name)
        src = open(path).read()
        a = src.index(kernel)
        b = src.index("\n}\n", src.index("qb3::store_window", a))
        body = src[a:b]
        edits = [
            ("  const int tid = threadIdx.x;\n",
             "  const int tid = threadIdx.x;\n  const unsigned long long t_entry = qb3::gtime();\n"),
            ("  __syncthreads();\n", "  __syncthreads();\n  {\n    const int64_t vb = s_vb;\n"
             "    STAMP_IF(tid == 0, 1)\n    if (tid == 0 && vb < (1 << 17)) "
             "qb3::g_stamp[vb * 8] = t_entry;\n  }\n"),
            ("  qb3::stage(sp, qb3::smem_addr(&bar));\n",
             "  qb3::stage(sp, qb3::smem_addr(&bar));\n  STAMP(2)\n"),
            ("    w.flush();\n  }\n", "    w.flush();\n  }\n  STAMP(4)\n"),
        ]
        for old, new in edits:
            if old not in body:
                raise SystemExit(f"{name}: the kernel changed; no '{old.strip()}' to stamp")
            body = body.replace(old, new, 1)
        body = re.sub(r"(qb3::block_scan\([^;]*;\n)", r"\1  STAMP(3)\n", body, count=1)
        body, n = re.subn(r"(  __syncthreads\(\);\n)(  qb3::store_window\([^;]*;)",
                          r"  STAMP(5)\n\1  STAMP(6)\n\2\n  STAMP(7)", body,
                          count=1)
        if n != 1:
            raise SystemExit(f"{name}: the kernel changed; no store_window to stamp")
        src = src[:a] + body + src[b:] + f"""
extern "C" int qb3_stamps_{tag}(void* dst, int64_t n) {{
  return static_cast<int>(cudaMemcpyFromSymbol(dst, qb3::g_stamp, n * 8));
}}
"""
        open(path, "w").write(src)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--set", action="append", default=[], help="NAME=VALUE of csrc/blockpack.cuh")
    p.add_argument("--label", default="base", help="a name for the copy and the output")
    args = p.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    dst = os.path.join(HERE, "ab", f"phases-{args.label}")
    instrument(dst, args.set)
    sys.path.insert(0, dst)
    from qb3_tpu_torch import _build
    from qb3_tpu_torch.benchutil import headline_image
    from qb3_tpu_torch.ops.encode_cuda import encode_pack_image
    from qb3_tpu_torch.ops.pack_cuda import PACK_G, pack_groups_chunked

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    lib = _build.load()
    copy = {}
    for tag in ("k1", "k8"):
        fn = getattr(lib, f"qb3_stamps_{tag}")
        fn.argtypes, fn.restype = [ctypes.c_void_p, ctypes.c_int64], ctypes.c_int
        copy[tag] = fn
    dev = torch.device("cuda")
    print(smoke.card_line(), flush=True)

    def report(label, tag, nblocks, fn):
        t = smoke.launch_times(fn)
        fn()
        torch.cuda.synchronize()
        raw = np.zeros(nblocks * 8, np.uint64)
        if copy[tag](raw.ctypes.data, nblocks * 8):
            raise RuntimeError("reading the stamps failed")
        s = raw.reshape(nblocks, 8).astype(np.int64)
        s -= s[:, 0].min()
        d = np.stack([s[:, 1] - s[:, 0], s[:, 2] - s[:, 1], s[:, 3] - s[:, 2], s[:, 4] - s[:, 3],
                      s[:, 5] - s[:, 4], s[:, 6] - s[:, 5],
                      s[:, 7] - s[:, 6]], 1) / 1e3
        last = int(np.argmax(s[:, 7]))
        print(f"{args.label} {label}: device {t['busy_ms']:.4f} ms a call in {t['ops']:g} ops; "
              f"{nblocks} blocks over {s[:, 7].max() / 1e3:.2f} us, starts median / p90 / max "
              + " / ".join(f"{v / 1e3:.2f}" for v in np.percentile(s[:, 0], [50, 90, 100]))
              + " us", flush=True)
        print("   us median / p90 / max: " + "; ".join(
            f"{n} {np.median(d[:, i]):.2f} / {np.percentile(d[:, i], 90):.2f} / {d[:, i].max():.2f}"
            for i, n in enumerate(PHASES)), flush=True)
        print(f"   last block: " + ", ".join(f"{n} {d[last, i]:.2f}" for i, n in enumerate(PHASES)),
              flush=True)

    img = headline_image()
    tiles = np.stack([headline_image(seed=100 + i) for i in range(smoke.BATCH)])
    for label, a in smoke.k1_cases(img, tiles, dev):
        lead = a[0].shape[:-2]
        nblocks = int(np.prod(lead)) * -(-a[0].shape[-2] // PACK_G)
        report(f"K1 {label}", "k1", nblocks, lambda a=a: pack_groups_chunked(*a))
        del a
    for label, skipstep, x, o, a in smoke.k8_cases(dev):
        h, w, c = x.shape
        nblocks = (h // 4) * -(-(w // 4) // max(1, PACK_G // c))
        report(f"K8 {label} {'FTL' if skipstep else 'BASE'}", "k8", nblocks,
               lambda a=a: encode_pack_image(*a))
        del o, a
    return 0


if __name__ == "__main__":
    sys.exit(main())
