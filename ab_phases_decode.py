#!/usr/bin/env python3
"""Phase times of K4 (the fused "ix" walk), K2 (the "ic" chunk walk) and
K5a / K5b (the walks on gathered windows) on one CUDA card, from a copy of
a checkout's qb3_tpu_torch with time stamps in the kernels.

    python3 ab_phases_decode.py [--root DIR] [--label NAME] [--set NAME=VALUE ...]
                                [--only k4|k2|k5]

Copies DIR's qb3_tpu_torch (default: this checkout's) into
ab/phases-<label>/ (git-ignored), sets the named constants of
csrc/fusedwin.cu there (for example --set kRounds=1 to time one round a
block), and turns on the kernels' stamp points (QB3_STAMP in
csrc/fusedwin.cu, QB3_PHASE in csrc/chunkwalk.cu and csrc/wavefront.cu,
empty in the library); a checkout whose kernels have none (f6c4044 for K4
and K2, a14777a for K5) gets them at the same places.  The copy builds its
own kernels.

K4, parsing, at chip_smoke.py's "ix" shapes: thread 0 of every block
records the card's %globaltimer at entry, after its ticket, after the
staging, after its codeswitch parse, after the in-block band scan, after
the look-back (and its barrier), after its own walk and after its store;
printed are the median, 90th percentile and largest time of each phase
over the blocks of one call after a warm-up, the spread of the blocks'
starts, and the phases of the block that finished last.

K2 at chip_smoke.py's "ic" shapes: every thread (one chunk) adds the SM
cycles (clock64) between its stamp points to its phases: the window reads
(the staging wait, and where the kernel reads its window words apart from
the walk, the wait for them), the walk (codeswitches, VLC and window reads
within it) and the store; printed are the median, 90th percentile and
largest of each over the chunks, in us at the SM clock that the chunks'
own cycles over their %globaltimer ns give.

K5a / K5b at every launch shape of chip_smoke.py (the "ix" K5 branch, the
best-mode kinds, the walks, the strip reads, the u8 scene's walk): every
thread (one group) adds the SM cycles between its stamp points to its
phases, as K2's do: staging (its off, rung and kind, and the block's
window rows where the kernel stages them, or the first window words where
it reads them directly), the walk (VLC and refills, the uniques and CF)
and the store; printed as K2's.

Each call's device ms comes from a profile, as chip_smoke.py's launch_times
takes it; the stamps cost a few instructions a phase.
"""

import argparse
import importlib.util
import os
import re
import shutil
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
K4_PHASES = ("ticket", "stage", "parse", "scan", "look-back", "walk", "store")
K2_PHASES = ("reads", "walk", "store")
K5_PHASES = ("stage", "walk", "store")
K4_SLOTS, K2_SLOTS = 8, 8  # stamp words a K4 block, a K2 chunk
K4_MAX, K2_MAX = 1 << 17, 1 << 19  # blocks, chunks recorded

K4_DEFS = f"""static __device__ unsigned long long qb3_stamps[{K4_MAX * K4_SLOTS}];
static __device__ __forceinline__ unsigned long long qb3_gtime() {{
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)::"memory");
  return t;
}}
#define QB3_ENTRY const unsigned long long qb3_entry = qb3_gtime();
#define QB3_STAMP(k) \\
  if (threadIdx.x == 0 && blk < {K4_MAX}) {{ \\
    if ((k) == 1) qb3_stamps[blk * {K4_SLOTS}] = qb3_entry; \\
    qb3_stamps[blk * {K4_SLOTS} + (k)] = qb3_gtime(); \\
  }}
"""
K2_DEFS = f"""static __device__ unsigned long long qb3_stamps[{K2_MAX * K2_SLOTS}];
static __device__ __forceinline__ unsigned long long qb3_clock() {{
  unsigned long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t)::"memory");
  return t;
}}
static __device__ __forceinline__ unsigned long long qb3_gtime() {{
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)::"memory");
  return t;
}}
#define QB3_PHASE_BEGIN \\
  unsigned long long qb3_acc[3] = {{0, 0, 0}}; \\
  unsigned long long qb3_t = qb3_clock(); \\
  const unsigned long long qb3_c0 = qb3_t, qb3_g0 = qb3_gtime();
#define QB3_PHASE(k) \\
  {{ const unsigned long long t_ = qb3_clock(); qb3_acc[k] += t_ - qb3_t; qb3_t = t_; }}
// a store of v_ cannot issue before v_ has arrived: the next stamp waits for it
#define QB3_PHASE_WAIT(v_) \\
  {{ volatile __shared__ uint32_t qb3_sink[1024]; qb3_sink[threadIdx.x] = (v_); }}
#define QB3_PHASE_END(c) \\
  if ((c) < {K2_MAX}) {{ \\
    unsigned long long* s_ = qb3_stamps + (c) * {K2_SLOTS}; \\
    s_[0] = qb3_acc[0]; s_[1] = qb3_acc[1]; s_[2] = qb3_acc[2]; \\
    s_[3] = qb3_clock() - qb3_c0; s_[4] = qb3_gtime() - qb3_g0; \\
  }}
"""

# f6c4044's kernels, which have no stamp points: (anchor, text put after it)
PARENT_K4 = [
    ("  int64_t blk = blockIdx.x;\n", "  QB3_ENTRY\n"),
    ("    blk = s_blk;\n", "    QB3_STAMP(1)\n"),
    ("    s_win4[q] = v;\n  }\n  __syncthreads();\n", "  QB3_STAMP(2)\n"),
    ("    if (w0 & 1ull) delta = qb3::dsw(w0 >> 1, UBITS, &cs_len);\n", "    QB3_STAMP(3)\n"),
    ("      s_x[tid] += add;\n      __syncthreads();\n    }\n", "    QB3_STAMP(4)\n"),
    ("      s_carry[b] = carry;\n    }\n    __syncthreads();\n", "    QB3_STAMP(5)\n"),
    ("  if (apply_step && kind == 1 && rung >= 1) qb3::step_restore(vals, rung);\n",
     "  QB3_STAMP(6)\n"),
    ("  for (int q = 0; q < 8; ++q) dst[q] = make_ulonglong2(vals[2 * q], vals[2 * q + 1]);\n",
     "  QB3_STAMP(7)\n"),
]
PARENT_K2 = [
    ("  if (c >= nchunks) return;\n", "  QB3_PHASE_BEGIN\n"),
    ("  uint4* dst = reinterpret_cast<uint4*>(out + c * static_cast<int64_t>(K) * NB * 16);\n",
     "  QB3_PHASE(0)\n"),
    ("  for (int g = 0; g < K * NB; ++g) {\n", "    QB3_PHASE(2)\n"),
    ("      regs[i] = (r >= 0 && r < R) ? twin[r] : words[base + i];\n    }\n",
     "    QB3_PHASE_WAIT(regs[0] ^ regs[NREG - 1])\n    QB3_PHASE(0)\n"),
    ("    if (apply_step && is_group) qb3::step_restore(vals, rung);\n", "    QB3_PHASE(1)\n"),
    ("    off += o - phase;\n  }\n", "  QB3_PHASE(2)\n  QB3_PHASE_END(c)\n"),
]
# a14777a's K5a / K5b, which have no stamp points: (anchor, text put after
# it, times the anchor occurs: once in each kernel where 2)
PARENT_K5 = [
    ("  if (g >= ngroups) return;\n", "  QB3_PHASE_BEGIN\n", 2),
    ("  k += 2;\n",
     "  QB3_PHASE_WAIT(static_cast<uint32_t>(acc) ^ static_cast<uint32_t>(kind))\n"
     "  QB3_PHASE(0)\n"),
    ("  const int rung = rung_in[g], kind = kind_in[g];\n",
     "  QB3_PHASE_WAIT(rung ^ kind)\n  QB3_PHASE(0)\n"),
    ("    take_uniques(vals, uq);\n  }\n", "  QB3_PHASE(1)\n", 2),
    ("    dst[q] = make_uint4(vals[4 * q], vals[4 * q + 1], vals[4 * q + 2], vals[4 * q + 3]);\n",
     "  QB3_PHASE(2)\n  QB3_PHASE_END(g)\n"),
    ("  for (int q = 0; q < 8; ++q) dst[q] = make_ulonglong2(vals[2 * q], vals[2 * q + 1]);\n",
     "  QB3_PHASE(2)\n  QB3_PHASE_END(g)\n"),
]


def instrument(src_root: str, dst: str, settings=()):
    """Copy src_root's package to dst with the stamps turned on and the
    constants of fusedwin.cu set."""
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(src_root, "qb3_tpu_torch"), os.path.join(dst, "qb3_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    csrc = os.path.join(dst, "qb3_tpu_torch", "csrc")
    for name, tag, defs, parent, mark in (("fusedwin.cu", "k4", K4_DEFS, PARENT_K4, "QB3_STAMP"),
                                          ("chunkwalk.cu", "k2", K2_DEFS, PARENT_K2, "QB3_PHASE"),
                                          ("wavefront.cu", "k5", K2_DEFS, PARENT_K5,
                                           "QB3_PHASE")):
        path = os.path.join(csrc, name)
        src = open(path).read()
        for kv in settings if tag == "k4" else ():
            key, value = kv.split("=")
            src, n = re.subn(rf"constexpr (\w+) {key} = [^;]+;", rf"constexpr \1 {key} = {value};",
                             src)
            if n != 1:
                raise SystemExit(f"no constant {key} in csrc/fusedwin.cu")
        if mark not in src:
            for anchor, text, *times in parent:
                if src.count(anchor) != (times or [1])[0]:
                    raise SystemExit(f"{name}: '{anchor.strip()}' is not where it was")
                src = src.replace(anchor, anchor + text)
        head = src.index("#include")
        src = src[:head] + "#include <cstdint>\n" + defs + src[head:] + f"""
extern "C" int qb3_stamps_{tag}(void* dst, int64_t n) {{
  if (!dst) {{
    void* p;
    const cudaError_t err = cudaGetSymbolAddress(&p, qb3_stamps);
    return static_cast<int>(err ? err : cudaMemset(p, 0, sizeof(qb3_stamps)));
  }}
  return static_cast<int>(cudaMemcpyFromSymbol(dst, qb3_stamps, n * 8));
}}
"""
        open(path, "w").write(src)


def stats(x) -> str:
    return " / ".join(f"{v:.2f}" for v in (np.median(x), np.percentile(x, 90), x.max()))


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=HERE, help="the checkout whose kernels are stamped")
    p.add_argument("--label", default="base", help="a name for the copy and the output")
    p.add_argument("--set", action="append", default=[], help="NAME=VALUE of csrc/fusedwin.cu")
    p.add_argument("--only", choices=("k4", "k2", "k5"), help="time one kernel")
    args = p.parse_args()
    import ctypes

    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    dst = os.path.join(HERE, "ab", f"phases-{args.label}")
    instrument(os.path.abspath(args.root), dst, args.set)
    sys.path.insert(0, dst)
    from qb3_tpu_torch import _build, batch
    from qb3_tpu_torch.benchutil import headline_image
    from qb3_tpu_torch.ops.chunkwalk_cuda import chunkwalk8
    from qb3_tpu_torch.ops.fusedwin_cuda import wavefront_fused
    from qb3_tpu_torch.ops.pack_cuda import extract_windows

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    lib = _build.load()
    read = {}
    for tag in ("k4", "k2", "k5"):
        fn = getattr(lib, f"qb3_stamps_{tag}")
        fn.argtypes, fn.restype = [ctypes.c_void_p, ctypes.c_int64], ctypes.c_int
        read[tag] = fn
    dev = torch.device("cuda")
    print(smoke.card_line(), flush=True)

    def stamps(tag, n, slots, fn):
        """The call's times, and the stamps of one call: rows of the blocks or
        chunks that ran (a block of several rounds covers several rows' worth
        of groups, so fewer rows than n may hold stamps)."""
        t = smoke.launch_times(fn)
        torch.cuda.synchronize()
        raw = np.zeros(n * slots, np.uint64)
        if read[tag](None, 0):
            raise RuntimeError("clearing the stamps failed")
        fn()
        torch.cuda.synchronize()
        if read[tag](raw.ctypes.data, n * slots):
            raise RuntimeError("reading the stamps failed")
        s = raw.reshape(n, slots).astype(np.int64)
        return t, s[s[:, 1] != 0] if tag == "k4" else s

    for label, x in smoke.ix_cases().items() if args.only in (None, "k4") else ():
        a = smoke.ix_inputs(batch.encode_tiles(x, index=True, device=dev), dev)
        nblocks = min(-(-a["goff"].numel() // 128), K4_MAX)
        fn = lambda a=a: wavefront_fused(a["words32"], a["goff"], a["nreg"], a["R"], a["tbits"],
                                         nbands=a["nb"], per_tile=a["per_tile"])
        t, s = stamps("k4", nblocks, K4_SLOTS, fn)
        nblocks = s.shape[0]
        s = s - s[:, 0].min()
        d = np.diff(s, axis=1) / 1e3
        last = int(np.argmax(s[:, 7]))
        print(f"{args.label} K4 {label}: device {t['busy_ms']:.4f} ms a call in {t['ops']:g} ops; "
              f"{nblocks} blocks over {s[:, 7].max() / 1e3:.2f} us, starts median / p90 / max "
              f"{stats(s[:, 0] / 1e3)} us", flush=True)
        print("   us median / p90 / max: " + "; ".join(
            f"{n} {stats(d[:, i])}" for i, n in enumerate(K4_PHASES)), flush=True)
        print("   last block: " + ", ".join(f"{n} {d[last, i]:.2f}"
                                            for i, n in enumerate(K4_PHASES)), flush=True)
        del a

    img = headline_image()
    tiles = np.stack([headline_image(seed=100 + i) for i in range(smoke.BATCH)])
    u16 = headline_image(1024, 1024, 1, seed=7, dtype=np.uint16)
    k2_cases = smoke.k3_cases(img, tiles, u16, dev) if args.only in (None, "k2") else ()
    for label, streams, ubits in k2_cases:
        a = smoke.walk_inputs(streams, dev)
        win = extract_windows(a["words32"], a["wrow"], a["R"])
        nchunks = min(a["starts"].numel(), K2_MAX)
        fn = lambda a=a, win=win, ubits=ubits: chunkwalk8(
            a["words32"], win, a["wrow"], a["starts"], a["entry"], a["k"], a["nb"], False, ubits)
        t, s = stamps("k2", nchunks, K2_SLOTS, fn)
        ghz = np.median(s[:, 3] / np.maximum(s[:, 4], 1))
        us = s[:, :4] / ghz / 1e3
        print(f"{args.label} K2 {label}: device {t['busy_ms']:.4f} ms a call in {t['ops']:g} ops; "
              f"{nchunks} chunks, SM clock {ghz:.3f} GHz; chunk us median / p90 / max: "
              + "; ".join(f"{n} {stats(us[:, i])}" for i, n in enumerate(K2_PHASES))
              + f"; all {stats(us[:, 3])}", flush=True)
        del a, win

    def k5_shapes():
        for label, x in smoke.ix_cases().items():
            yield f"ix {label}", smoke.k5_ix_case(batch.encode_tiles(x, index=True, device=dev),
                                                  dev)
        for label, case, _ in smoke.k5_decode_cases(dev):
            yield label, case

    for label, case in k5_shapes() if args.only in (None, "k5") else ():
        name, kern, _ = smoke.k5_kernel(case["tbits"])
        kargs = smoke.k5_args(case)
        ng = case["kind"].numel()
        t, s = stamps("k5", min(ng, K2_MAX), K2_SLOTS, lambda kargs=kargs: kern(*kargs))
        ghz = np.median(s[:, 3] / np.maximum(s[:, 4], 1))
        us = s[:, :4] / ghz / 1e3
        print(f"{args.label} {name} {label}: device {t['busy_ms']:.4f} ms a call in "
              f"{t['ops']:g} ops; {ng} groups, nreg {case['nreg']}, {s.shape[0]} stamped, SM "
              f"clock {ghz:.3f} GHz; group us median / p90 / max: "
              + "; ".join(f"{n} {stats(us[:, i])}" for i, n in enumerate(K5_PHASES))
              + f"; all {stats(us[:, 3])}", flush=True)
        del case, kargs
    return 0


if __name__ == "__main__":
    sys.exit(main())
