#!/usr/bin/env python3
"""Smoke run of qb3_tpu_torch's main path on one CUDA card (an H100).

    python3 chip_smoke.py

The main paths: FTL encode of a 512x512x3 u8 raster with the self-contained
"ic" sidecar, then decode driven by that sidecar, one image at a time and as
a batch of 128 tiles; the "ix" sidecar encode and decode at the shapes of
the bench rows it serves (u8 512x512x3 single and 128 tiles, u16
1024x1024x1, u16 512x512x8, u32 and u64 1024x1024x1, u64 8 tiles); the
image-layout encode that the public encode takes for u16/u32/u64 images, at
the four wide single shapes; the decode of streams without a sidecar (the
default encode's, and the best-mode streams the C reference and qb3_tpu
write by default), by the serial walk on the host and K7 + K5 on the card,
at the headline and wide shapes and on the repository's Landsat sample (a
512x512x8 u16 CF_H stream); the streaming strips (StripEncoder /
StripDecoder) of a u8 4096x4096x3 FTL scene and a u16 4096x4096x1 BASE_H
elevation raster in 256-row strips, stitched on the card by K6's stitch
entry; the best
modes (CF_H): the encode (phase A in K10, then K1 at 27 or 43
symbols a group) with the "ib" and "ic" sidecars and without, their
decodes (K7 + K5, the "ic"-best chunk walk in plain PyTorch, the serial
walk), a batch of 128 u8 512x512x3 tiles with "ib" and the u16 elevation
raster's strips; and the Mosaic probes (`python -m qb3_tpu_torch.probes`)
on P1-P7.  Phases, each printed on earlier lines:

  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build the CUDA kernels from qb3_tpu_torch/csrc, one nvcc per source,
     and measure the launch floor (an empty kernel's device time);
  3. K9 (the fast phase A in one launch) at one u8 512x512x3 tile and 128
     of them, its outputs compared field by field, K10 (the best phase A in
     one launch) at a Landsat pass of 8 tiles, one u8 tile and the u64
     1024x1024x1 raster the same way, K11 (the step of a quantized
     encode) at the DEM cell's i16 512x6000x1 and 368x6000x1 strips at
     q 4 against api.quantize on the host (also with the L2 cache flushed
     before each call), then K1 (pack, on K9's
     outputs), K3 (window copy) and K2 (chunk walk) at the "ic" path's
     shapes, then K4 (fused "ix" walk, both modes), K5a and K5b (walks on
     gathered windows) at the "ix" shapes, then K8 (fused image-layout VLC
     + pack) at the wide shapes, FTL and BASE, and at the photo cell's u16
     512x7216x3 and 292x7216x3 strips (FTL), then K7 (window gather) at
     the walk's u8 512x512x3 and u64 1024x1024x1 windows and the 128-tile
     best batch's "ib" windows, then (3d) K5a and
     K5b at every other launch shape: best-mode kinds (CF, CF0, IDX; the
     Landsat sample's groups, a damaged 512x512x3 BASE_H stream whose walk
     meets best-mode codes, u32 / u64 random windows over every kind, with
     kind counts), the seven walk decodes of phase 5, a StripDecoder read
     of each strip scene and the walk of the whole u8 scene, the best
     modes' "ib" decodes (u8 512x512x3, u64 1024x1024x1, 128 u8 tiles) and
     a best strip read of the u16 raster, then on the
     edge inputs of tests/k5_edges.py, then (3e)
     K6's two entries at the stitch of the u8 4096x4096x3 strip encode and
     of the u16 raster's best strips: the slab entry (zero fill + atomics)
     at the slabs the CPU route cuts (beside index_add_) and the stitch
     entry on the strips where they lie (against its twin and the host
     stitch_bytes), each also timed with the L2 cache flushed before every
     call, then (3f) P1-P7 at their
     probes' shapes (and P1 at the shapes of tests/p1_cases.py and on
     unaligned bases), then (3g) K4 and K2
     on the edge inputs of tests/walk_edges.py, then (3h) K1 at the best
     encode's shapes (u8 512x512x3 CF_H, 27 symbols a group; u64
     1024x1024x1 CF_H, 43), each against its
     plain PyTorch twin (exact equality) and, for the probes, the probe's
     own check; median times, twin times, bounds and a one-call yardstick
     (K3 and K7 at every shape also with their device ms and host enqueue
     us beside torch.take's; K9, K1, K8, K4, K2 and K5 at every shape with
     the device ms and the device operations of a call from a profile, which
     must be the kernel and at most one memset, for K9, K2 and K5 the kernel
     alone, for K6's stitch entry the kernel and at most the run table's
     copy; each probe, and K6,
     beside its one-call comparator's median, device ms and enqueue us);
  4. golden bytes: the committed web fixtures (streams pinned to the C
     reference) all decoded to their raw bytes and re-encoded by the port
     to their bytes, the three best-mode ones included, the headline
     stream's sha256, the best headline's (CF_H) with "ib" and with "ic",
     and the four wide "ix" streams' sha256s (through the image-layout
     encode); the Landsat sample decoded and encoded again to its own bytes
     (CF_H), and decoded to its pinned sha256 through the C++ walk, K7 and
     K5b, with the twins refused;
  5. the main paths through the public API with the launch counters reset:
     "ic" single image, 128-tile batch, u16 1024x1024x1 and u64 256x256x1
     round trips, "ix" round trips at every "ix" shape and the K5 branch of
     decode_indexed_narrow, the wide images' "ix" and "ic" round trips
     through the image-layout encode; then device-resident and host-to-host
     MB/s, the "ix" decode's device time split into K4 and reconstruct, and
     at the wide shapes the block encode (phase A + K1) against the
     image-layout one (equal outputs, device MB/s, the latter split into
     phase A and K8); the decode without a sidecar (the C++ walk, K7, K5)
     at the headline u8 shape (FTL, BASE_Z and RLE_H) and the four wide
     shapes, its split into host walk, upload, K7, K5 and reconstruct, a
     device profile, and host-to-host MB/s beside the "ic" and "ix" decodes
     of the same image; the streaming strips: each strip stream equal to the
     whole-image encode on the card, decoded losslessly in 256-row reads by
     the C++ walk, K7 and K5, the launch counts of the strip encode (K6's
     stitch entry once, K1 or K8 once a strip) and decode read per stream,
     host-to-host MB/s of
     the strip and whole-image encodes and decodes, K6's stitch (at most 3
     device ops) beside the host stitch and the slab route it replaced (the
     slab cut in plain PyTorch, then zero fill + atomics), the strip encode
     with each stitch in turns, and the peak device memory of the strip
     encode against the whole-image encode; the best modes: u8 512x512x3
     and u64 1024x1024x1 CF_H round trips with "ib" ("ib" decode), "ic"
     ("ic-best") and no sidecar (the walk), device-resident and host-to-host
     MB/s, the encode split into phase A and K1 and the "ic"-best decode
     into its walk and reconstruct, a CF_H batch of 128 tiles with "ib"
     (one K1, one K7 and one K5a launch, peak device memory) and the u16
     elevation raster through the best StripEncoder / StripDecoder (equal to
     the whole-image encode, K1 a strip, K6's stitch entry once, K7 + K5b
     a strip read, peak device memory); the DEM cell's encode, a
     6000x6000x1 int16 scene through the CF_RLE_H StripEncoder at q 4 in
     512-row strips (12 K11 launches, twins refused, the payload equal to
     the host quantizer's route, host-to-host MB/s of both); the photo
     cell's encode, a 7216x5412x3 u16 image through the FTL StripEncoder in
     512-row strips (11 K8 launches, K6's stitch entry once, no K9 or K1,
     twins refused), equal to the one-shot encode's stream and to the
     plain reference's (portbench/reference/qb3ref.py), decoded on the card
     (K7 + K5b) to the image, with each run's peak device memory and time
     and host-to-host MB/s of the strips; the Landsat sample's decode
     host to host, split the same way, with a device profile; the probes'
     path with all seven names, in this process (launch counts) and as
     `python -m qb3_tpu_torch.probes` (an OK line per probe);
  6. the serving paths (pipeline.py, foreign.py, cli.py; serving_phase);
  7. the sharded paths (parallel/sharded.py; sharded_phase), 4 shards on
     the one card: encode_sharded of the u8 scene ("ic", "ix", none, BASE_H
     "ix"), the fast and scatter stitches, and the u16 raster in CF_H "ib",
     each equal to the single-device encode; the headline over 2, 4 and 8
     shards, the best headline and the four wide rasters to their sha256
     pins; the sharded "ix", "ic" and "ib" decodes equal to their scenes; the
     2-D mesh of the 128 tiles over 2 x 2 shards equal to the single-device
     payloads; the group's bytes a call, each stage's host ms (the K6
     stitch among them), host-to-host MB/s beside the single device (3 runs
     in turns), the idle share and the peak device memory;
  8. the timing helpers (timing_phase): benchutil.sync waits for a sleep
     queued on the current stream and one on a second stream and returns
     at once for a tree of host leaves, the cost of one sync after a
     trivial op, benchutil.sustained_stats' mean, MB/s and sigma at 30 and
     100 calls x 3 windows on phase 5's device-resident "ic" encode and
     decode (one tile, 128 tiles) beside sustained's, and
     profiling.trace(host=True) of an "ic" round trip naming K1 and K2.

Launch counts are set to 0 just before each main path and read just after,
every twin refused in phases 6 and 7; each kernel's count in the result is
from the paths that run it, summed over the "ix", walk, strip, best, photo,
serving and sharded paths.  The line
also holds K1 at the best modes' symbol counts as two entries of their own
(BEST_K1), their launches counted on the best paths, and K6's stitch
entry ("place_slabs stitch", counted by place_parts.launches and launched
by every device stitch; the slab entry, place_slabs, is on no path and
its count is 0), and K8 at the photo cell's 512-row strip
("encode_pack_image photo", its launches counted on the photo path).  Any
failure exits non-zero and prints no result.  The line before the last is
{"kernels": [...]} (each kernel's error, median ms, twin ms, bound ms, and
a one-call PyTorch yardstick where one exists; device ms where a profile
took it, and the yardstick's for K3 and K7), the last {"ok": true,
"device": {...}}.  A bound is the larger of the bytes the function needs
(each input read once and each output written once, at the width of its
values, not of the port's int64 carriers) at the memory rate, the
integer operations this run's data needs at the INT32 rate (P1's products
at the bf16 rate), and the launch floor of phase 2 (each entry's
floor_ms), the least time any kernel takes.  It needs a
CUDA device and the repository around it; it imports no JAX.
"""

import base64
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
BATCH = 128
KERNELS = {  # name -> (source in the repo, file:line of the TPU kernel's pallas_call, or
    # what it replaces where qb3_tpu has no kernel there)
    "pack_groups_chunked": ("qb3_tpu_torch/csrc/pack.cu", "qb3_tpu/ops/pack_pallas.py:228"),
    "extract_windows": ("qb3_tpu_torch/csrc/pack.cu", "qb3_tpu/ops/pack_pallas.py:295"),
    "chunkwalk8": ("qb3_tpu_torch/csrc/chunkwalk.cu", "qb3_tpu/ops/chunkwalk_pallas.py:211"),
    "wavefront_fused": ("qb3_tpu_torch/csrc/fusedwin.cu", "qb3_tpu/ops/fusedwin_pallas.py:423"),
    "wavefront8": ("qb3_tpu_torch/csrc/wavefront.cu", "qb3_tpu/ops/wavefront_pallas.py:129"),
    "wavefront_wide": ("qb3_tpu_torch/csrc/wavefront.cu", "qb3_tpu/ops/wavefront_pallas.py:284"),
    "gather_slabs": ("qb3_tpu_torch/csrc/gather.cu", "qb3_tpu/ops/pack_pallas.py:339"),
    "encode_pack_image": ("qb3_tpu_torch/csrc/encode_image.cu",
                          "qb3_tpu/ops/encode_pallas.py:322"),
    "place_slabs": ("qb3_tpu_torch/csrc/place.cu", "qb3_tpu/ops/pack_pallas.py:388"),
    "phase_a_fast": ("qb3_tpu_torch/csrc/phase_a.cu",
                     "none: XLA ops (qb3_tpu/ops/encode.py encode_fast_blocks)"),
    "phase_a_best": ("qb3_tpu_torch/csrc/phase_a_best.cu",
                     "none: XLA ops (qb3_tpu/ops/encode_best.py encode_best_blocks)"),
    "quantize_carrier": ("qb3_tpu_torch/csrc/quantize.cu",
                         "none: host NumPy (qb3_tpu/api.py quantize)"),
    "probe_dim0_dot": ("qb3_tpu_torch/csrc/probes.cu", "tools/probe_mosaic.py:24"),
    "probe_1d_dma": ("qb3_tpu_torch/csrc/probes.cu", "tools/probe_mosaic.py:49"),
    "probe_flatten": ("qb3_tpu_torch/csrc/probes.cu", "tools/probe_mosaic.py:62"),
    "probe_3d_dma": ("qb3_tpu_torch/csrc/probes.cu", "tools/probe_mosaic.py:86"),
    "probe_lane_write": ("qb3_tpu_torch/csrc/probes.cu", "tools/probe_mosaic.py:108"),
    "probe_lane_concat": ("qb3_tpu_torch/csrc/probes.cu", "tools/probe_mosaic.py:123"),
    "probe_flatten_big": ("qb3_tpu_torch/csrc/probes.cu", "tools/probe_mosaic.py:138"),
}
# the kernels line's entries of K1 at the best modes' symbol counts: name ->
# the raster of phase 3's shape
BEST_K1 = {"pack_groups_chunked best S=27": "u8 512x512x3",
           "pack_groups_chunked best S=43": "u64 1024x1024x1"}
STRIP_ROWS = 256  # rows a strip encodes and a strip read returns (phase 5)
# the DEM cell's scene (portbench/configs/srtm90-i16-cfrle-q4.json): int16
# rows x columns, encoded at the step DEM_Q in strips of DEM_ROWS rows
DEM_SIDE, DEM_ROWS, DEM_Q = 6000, 512, 4
# the photo cell's image (portbench/configs/rgb16-photo-ftl.json): uint16
# rows x columns x 3, FTL in strips of PHOTO_ROWS rows; PHOTO_K8, the kernels
# line's entry of K8 at its full strip
PHOTO_H, PHOTO_W, PHOTO_ROWS = 5412, 7216, 512
PHOTO_K8 = "encode_pack_image photo"
# phase 6: tiles a batch of bench.py's pipelined row (bench.py:381) and of
# its bulk foreign row (bench.py:266), 4 batches each
ROW_TILES, FOREIGN_TILES = 32, 24
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
# H100 SXM INT32 rate: 64 INT32 lanes per SM and clock (NVIDIA H100 Tensor
# Core GPU Architecture), 132 SMs, at the 1.98 GHz that the data sheet's
# 67 TFLOP/s float32 implies (132 SMs * 128 lanes * 2 flops * 1.98e9)
INT_OPS_PER_S = 132 * 64 * 1.98e9
BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet): P1's product
FLOOR_MS = 0.0  # the launch floor, measured in phase 2 (launch_floor)
# 32-bit integer operations a VLC needs, at the fewest: code one value (the
# rung 1..7 swap test, its two top bits, code and length) 5; place a code
# or one bit (shift to the bit offset, OR into the word, advance) 3; decode
# one value (peek at the cursor, the short / nominal tests, the value, the
# swap, advance) 8; a group's prefix or codeswitch and start bit 6.  Codes
# of u32 and u64 values pass 32 bits and take twice as many.
CODE_OPS, PLACE_OPS, DECODE_OPS, GROUP_OPS = 5, 3, 8, 6
# quantize one value at a step (the quotient, the remainder's tie test and
# its rounding, the unsigned twin's mask) 6
QUANT_OPS = 6
# bytes of one K1 input code: u8 codes reach 9 bits, u16 17, u32 33; the
# 65th bit of a u64 code is a symbol of its own
CODE_BYTES = {8: 2, 16: 4, 32: 8, 64: 8}


def fail(msg: str):
    raise SystemExit(f"FAIL: {msg}")


def check(cond, msg: str):
    if not cond:
        fail(msg)


def log(*parts):
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def walk_inputs(streams, dev):
    """api.ic_inputs for "ic" streams (one stream, or a same-shape batch in
    decode_tiles' flat tile layout), plus the K3 window rows and geometry."""
    from qb3_tpu_torch import api, container
    from qb3_tpu_torch.batch import _flat_tile_layout
    from qb3_tpu_torch.constants import TYPESIZES
    from qb3_tpu_torch.ops.decode import payload_words
    from qb3_tpu_torch.ops.decode_chunked import parse_ic

    infos = [container.parse_headers(s) for s in streams]
    i0 = infos[0]
    nblocks = ((i0.ysize + 3) // 4) * ((i0.xsize + 3) // 4)
    metas = [parse_ic(i.index_chunked, nblocks, i0.nbands) for i in infos]
    if len(streams) == 1:
        words, tile_words32 = api.padded_words(streams[0][i0.data_offset:]), 0
    else:
        words, tile_words32 = _flat_tile_layout(
            [payload_words(s[i.data_offset:]) for s, i in zip(streams, infos)])
    inp = api.ic_inputs(words, metas, tile_words32, 8 * TYPESIZES[i0.dtype], dev)
    return dict(inp, wrow=(inp["starts"][::128] >> 5) >> 7, nblocks=nblocks,
                nb=i0.nbands, cband=tuple(i0.cband))


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def stream_bytes(total) -> int:
    """Bytes of the stream words up to the total bits (per tile, summed)."""
    return int(((total + 31) // 32).sum()) * 4


def payload_bytes(streams) -> int:
    """Bytes of the streams' payloads (headers and sidecars left out)."""
    from qb3_tpu_torch import container

    return sum(len(s) - container.parse_headers(s).data_offset for s in streams)


def wide(tbits: int) -> int:
    """Operations per code: twice as many where codes pass 32 bits."""
    return 2 if tbits >= 32 else 1


def walk_ops(vals, tbits: int) -> int:
    """Integer operations a walk needs to decode the (..., 16) mag-sign
    values it returned: groups with a value above 1 decode 16 codes, groups
    of zeros and ones 16 single bits, and every group its codeswitch."""
    import torch

    vals = vals.reshape(-1, 16).to(torch.int64)
    coded = ((vals & ~1) != 0).any(-1)
    ones = (vals != 0).any(-1) & ~coded
    return (16 * (int(coded.sum()) * DECODE_OPS * wide(tbits) + int(ones.sum()) * PLACE_OPS)
            + vals.shape[0] * GROUP_OPS)


def work_ms(need) -> tuple:
    """(bytes ms, operations ms) of need, (bytes, ops) or (bytes, ops, ops
    per second): the bytes over the memory rate, the operations over their
    rate (the INT32 rate unless need names another)."""
    nbytes, ops, rate = (*need, INT_OPS_PER_S)[:3]
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / rate * 1e3


def bound(need) -> tuple:
    """(bound ms, "bytes", "operations" or "floor"): the largest of
    work_ms(need) and the launch floor (FLOOR_MS), the least time the card
    takes for any kernel; the word names the largest."""
    t_bytes, t_ops = work_ms(need)
    if FLOOR_MS > max(t_bytes, t_ops):
        return FLOOR_MS, "floor"
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def launch_floor(dev) -> float:
    """Phase 2: the launch floor, an empty kernel's device ms (one block of
    32 threads; launch_times' profile), set as FLOOR_MS for bound()."""
    global FLOOR_MS
    from qb3_tpu_torch.ops.probe_cuda import empty

    t = launch_times(lambda: empty(dev), "empty_kernel")
    check(t["device_ms"] > 0, f"the empty kernel left no device record: {t}")
    FLOOR_MS = t["device_ms"]
    log(f"launch floor: an empty kernel (1 block of 32 threads) takes {FLOOR_MS:.5f} ms on the "
        f"device ({pack_times_text(t)})")
    return FLOOR_MS


def compare(name, got, want):
    """Exact equality of kernel and twin outputs -> max abs difference."""
    import torch

    err = 0
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        check(g.shape == w.shape, f"{name}: shape {tuple(g.shape)} vs {tuple(w.shape)}")
        kind = torch.float64 if g.is_floating_point() else torch.int64
        d = (g.to(kind) - w.to(kind)).abs()
        err = max(err, d.max().item() if d.numel() else 0)
    check(err == 0, f"{name}: kernel disagrees with its twin (max abs err {err})")
    return err


def profiled(fn, iters: int = 10) -> dict:
    """benchutil.device_profile, logging a profile that had to be taken
    again or that still lacks device kernels (the profiler's lost records)."""
    from qb3_tpu_torch.benchutil import device_profile

    p = device_profile(fn, iters)
    if p["attempts"] > 1 or p["lost"]:
        log(f"the profile took {p['attempts']} attempts"
            + (f"; the one kept lacks {p['lost']} of its kernels" if p["lost"] else ""))
    return p


def launch_times(fn, op=None) -> dict:
    """One call's times three ways: ms, the median between CUDA events of 50
    calls (the larger of host enqueue and device time); device_ms, from a
    profile of 20 calls, the device operations whose name holds op (all of
    them without op); enqueue_us, the host clock over many calls without a
    synchronize after a warm-up (as many as queue ~5 ms of device work, at
    most 1000, so the launch queue never fills).  Also from the profile:
    busy_ms, the device time of every operation the call issues, ops, how
    many it issues, and names, theirs."""
    import torch

    from qb3_tpu_torch.benchutil import median_ms

    ms = median_ms(fn, 50)
    p = profiled(fn, 20)
    dev = p["busy_ms"] if op is None else sum(v for k, v in p["per_op"].items() if op in k)
    iters = min(1000, max(100, int(5 / max(p["busy_ms"], 1e-6))))
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dict(ms=ms, device_ms=dev, enqueue_us=t / iters * 1e6, busy_ms=p["busy_ms"],
                ops=p["ops"], names=sorted(p["per_op"]))


def times_text(t: dict) -> str:
    return (f"median {t['ms']:.4f} ms, device {t['device_ms']:.4f} ms, enqueue "
            f"{t['enqueue_us']:.2f} us")


def pack_times_text(t: dict) -> str:
    """A pack wrapper's times: its kernel's device ms and everything it
    issues (ops a call and their device ms)."""
    return (f"median {t['ms']:.4f} ms, device {t['busy_ms']:.4f} ms in {t['ops']:g} ops a call "
            f"(kernel {t['device_ms']:.4f} ms), enqueue {t['enqueue_us']:.2f} us")


def check_one_launch(name: str, t: dict, kernel: str, memset: bool = True):
    """K1, K8 and K4 issue their kernel and at most one memset a call, K2
    (memset False) its kernel alone."""
    extra = [n for n in t["names"] if kernel not in n and not (memset and "memset" in n.lower())]
    check(t["ops"] <= 1 + memset and not extra and any(kernel in n for n in t["names"]),
          f"{name}: {t['ops']:g} device ops a call ({t['names']}), want the kernel"
          + (" and at most one memset" if memset else " alone"))


def reset(kernels):
    """Set every launch count to 0."""
    for fn in kernels.values():
        fn.launches = 0


def peak_bytes(fn) -> int:
    """Peak device memory of fn() above what was allocated before it."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - before


def take_windows(words32, first, width: int):
    """The one-call yardstick of K3 and K7: torch.take on the zero-padded
    stream with the int64 index of every window word, built here, untimed
    -> a call computing out[t, j] = words32[first[t] + j], zero past the
    stream's end (first >= 0)."""
    import torch

    padded = torch.cat([words32, words32.new_zeros(width)])
    idx = (first.to(torch.int64)[:, None] + torch.arange(width, device=words32.device)).clamp(
        0, padded.numel() - 1)
    return lambda: torch.take(padded, idx)


def k3_cases(img, tiles, u16, dev) -> list:
    """K3's shapes on the "ic" decode: (label, streams, ubits) for one u8
    512x512x3 tile, BATCH of them and a u16 1024x1024x1 raster."""
    from qb3_tpu_torch import api
    from qb3_tpu_torch.batch import encode_tiles

    return [("single u8", [api.encode(img, index="ic", device=dev)], 3),
            (f"batch{BATCH} u8", encode_tiles(tiles, index="ic", device=dev), 3),
            ("1024x1024 u16", [api.encode(u16, index="ic", device=dev)], 4)]


def k7_inputs(x, dev) -> dict:
    """K7's inputs on the walk decode of x's default (FTL, no sidecar)
    stream: words32, base, nreg, R."""
    from qb3_tpu_torch import api
    from qb3_tpu_torch.constants import Mode

    return stream_walk(api.encode(x, mode=Mode.FTL, device=dev), dev)["inp"]


def k1_cases(img, tiles, dev):
    """K1's shapes on the "ic" encode, one at a time: (label, the arguments
    of pack_groups_chunked) for one u8 512x512x3 tile and BATCH of them."""
    import torch

    from qb3_tpu_torch import api
    from qb3_tpu_torch.constants import HILBERT
    from qb3_tpu_torch.ops import bitpack
    from qb3_tpu_torch.ops.phase_a_cuda import phase_a_fast

    n_words = api.stream_words(512, 512, 3, 0)
    maxbits = bitpack.group_bits_bound(8, best=False)
    for label, x in (("single", img), (f"batch{BATCH}", tiles)):
        lead = x.shape[:-3]
        zero = torch.zeros(*lead, 3, dtype=torch.int64, device=dev)
        codes, lens, _, _ = phase_a_fast(api.to_carrier(x, dev), zero, zero, HILBERT,
                                         (1, 1, 1), True, 8)
        yield label, (codes, lens, n_words, maxbits)


def k9_need(x, tbits: int, nsym: int) -> tuple:
    """(bytes, operations) K9 needs for the tiles x: the raster read once and
    the codes, lengths, rungs and exit state written once, at the widths of
    their values (CODE_BYTES a code, a byte a length and a rung); coding each
    value (CODE_OPS) and each group's prefix (GROUP_OPS)."""
    *lead, h, w, nb = x.shape
    ngroups = int(np.prod(lead, dtype=np.int64)) * -(-h // 4) * -(-w // 4) * nb
    nstate = int(np.prod(lead, dtype=np.int64)) * nb
    return (x.size * tbits // 8 + ngroups * (nsym * (CODE_BYTES[tbits] + 1) + 1)
            + 2 * nstate * tbits // 8,
            ngroups * (16 * CODE_OPS * wide(tbits) + GROUP_OPS))


def k9_phase(dev, card, img, tiles) -> dict:
    """Phase 3: K9 (the fast phase A in one launch) against its twin
    (ops/encode.encode_fast_blocks on the same card tensors) at the main
    path's shapes, one u8 512x512x3 tile and BATCH of them (FTL, Hilbert,
    core bands (1, 1, 1), a zero entry state, with the rungs): every output
    equal, field by field, in shape, dtype and value; its times, which must
    be the kernel alone a call, the twin's median and the bound."""
    import torch

    from qb3_tpu_torch import api
    from qb3_tpu_torch.benchutil import median_ms
    from qb3_tpu_torch.constants import HILBERT
    from qb3_tpu_torch.ops.encode import encode_fast_blocks
    from qb3_tpu_torch.ops.phase_a_cuda import phase_a_fast

    results = {}
    fields = ("codes", "lens", "exit_prev", "exit_runbits", "rung")
    for label, x in (("single", img), (f"batch{BATCH}", tiles)):
        zero = torch.zeros(*x.shape[:-3], 3, dtype=torch.int64, device=dev)
        args = (api.to_carrier(x, dev), zero, zero, HILBERT, (1, 1, 1), True, 8, True)
        got, want = phase_a_fast(*args), encode_fast_blocks(*args)
        check(len(got) == len(want) == len(fields), f"K9 {label}: {len(got)} outputs")
        for name, g, w in zip(fields, got, want):
            check(g.shape == w.shape and g.dtype == w.dtype,
                  f"K9 {label} {name}: {tuple(g.shape)} {g.dtype} vs {tuple(w.shape)} {w.dtype}")
            check(torch.equal(g, w), f"K9 {label} {name}: the kernel disagrees with its twin")
        need = k9_need(x, 8, got[0].shape[-1])
        carriers = nbytes(args[0], *got)
        del got, want
        t = launch_times(lambda: phase_a_fast(*args), "phase_a_kernel")
        check_one_launch(f"K9 {label}", t, "phase_a_kernel", memset=False)
        plain = median_ms(lambda: encode_fast_blocks(*args), 5)
        bms, by = bound(need)
        log(f"K9 phase_a_fast {label} {tuple(x.shape)}: equal field by field; "
            f"{pack_times_text(t)}; twin {plain:.4f} ms; bound {bms:.5f} ms by {by} "
            f"({need[0]} bytes, {need[1]} operations); the int64 carriers weigh {carriers} "
            f"bytes, {carriers / HBM_BYTES_PER_S * 1e3:.5f} ms ({card})")
        results.setdefault("phase_a_fast", (0, t["ms"], plain, need, None, t["busy_ms"], None))
        del args
    return results


def k10_need(x, tbits: int, nsym: int) -> tuple:
    """(bytes, operations) K10 needs for the tiles x: the raster read once;
    the codes and lengths (CODE_BYTES a code, a byte a length), meta16 (2
    bytes), cfv and pcf_in (the values' width), post_runbits (a byte) and
    the three exit states written once; coding each value twice (the plain
    and the divided group) and its index code, and the 8 uniques (CODE_OPS
    each), matching each value against 8 uniques and ranking them (8 * 16 +
    64), three headers (GROUP_OPS each)."""
    *lead, h, w, nb = x.shape
    ntiles = int(np.prod(lead, dtype=np.int64))
    ngroups = ntiles * -(-h // 4) * -(-w // 4) * nb
    meta = 2 + 2 * tbits // 8 + 1
    return (x.size * tbits // 8 + ngroups * (nsym * (CODE_BYTES[tbits] + 1) + meta)
            + 3 * ntiles * nb * tbits // 8,
            ngroups * ((32 * wide(tbits) + 24) * CODE_OPS + 8 * 16 + 64 + 3 * GROUP_OPS))


def landsat_pass():
    """A pass of the Landsat batch (landsat-cfh-ingest: batch.BEST_GROUPS
    groups, 8 tiles): the sample decoded, flipped and turned, and its core
    bands."""
    import qb3_tpu_torch as qt
    from qb3_tpu_torch import container
    from qb3_tpu_torch.benchutil import LANDSAT_SAMPLE

    with open(os.path.join(ROOT, LANDSAT_SAMPLE), "rb") as f:
        sample = f.read()
    land = qt.decode(sample, device="cpu")[0]
    views = [land, land[::-1], land[:, ::-1], np.rot90(land)]
    return np.ascontiguousarray(np.stack(views * 2)), tuple(container.parse_headers(sample).cband)


def k10_phase(dev, card, img) -> dict:
    """Phase 3: K10 (the best phase A in one launch) against its twin
    (ops/encode_best.encode_best_blocks on the same card tensors) at a
    Landsat pass (8 x 512x512x8 u16, the sample's core bands), one u8
    512x512x3 tile and the u64 1024x1024x1 raster (Hilbert, a zero entry
    state): every output equal, field by field, in shape, dtype and value;
    its times, which must be its memset and kernel alone a call, the twin's
    median and the bound."""
    import torch

    from qb3_tpu_torch import api
    from qb3_tpu_torch.benchutil import median_ms, wide_image
    from qb3_tpu_torch.constants import HILBERT
    from qb3_tpu_torch.ops.encode_best import encode_best_blocks
    from qb3_tpu_torch.ops.phase_a_cuda import phase_a_best

    results = {}
    fields = ("codes", "lens", "exit_prev", "exit_runbits", "exit_cf", "meta16", "cfv",
              "post_runbits", "pcf_in")
    land, land_cband = landsat_pass()
    cases = (("landsat pass", land, land_cband), ("u8 single", img, (1, 1, 1)),
             ("u64 1024x1024x1", wide_image("u64 1024x1024x1"), (0,)))
    for label, x, cband in cases:
        tb = 8 * x.itemsize
        zero = torch.zeros(*x.shape[:-3], x.shape[-1], dtype=torch.int64, device=dev)
        args = (api.to_carrier(x, dev), zero, zero, zero, HILBERT, cband, tb)
        got, want = phase_a_best(*args), encode_best_blocks(*args)
        check(len(got) == len(want) == len(fields), f"K10 {label}: {len(got)} outputs")
        for name, g, w in zip(fields, got, want):
            check(g.shape == w.shape and g.dtype == w.dtype,
                  f"K10 {label} {name}: {tuple(g.shape)} {g.dtype} vs {tuple(w.shape)} {w.dtype}")
            check(torch.equal(g, w), f"K10 {label} {name}: the kernel disagrees with its twin")
        need = k10_need(x, tb, got[0].shape[-1])
        carriers = nbytes(args[0], *got)
        del got, want
        t = launch_times(lambda: phase_a_best(*args), "phase_a_best_kernel")
        check_one_launch(f"K10 {label}", t, "phase_a_best_kernel")
        plain = median_ms(lambda: encode_best_blocks(*args), 5)
        bms, by = bound(need)
        log(f"K10 phase_a_best {label} {tuple(x.shape)}: equal field by field; "
            f"{pack_times_text(t)}; twin {plain:.4f} ms; bound {bms:.5f} ms by {by} "
            f"({need[0]} bytes, {need[1]} operations); the int64 carriers weigh {carriers} "
            f"bytes, {carriers / HBM_BYTES_PER_S * 1e3:.5f} ms ({card})")
        results.setdefault("phase_a_best", (0, t["ms"], plain, need, None, t["busy_ms"], None))
        del args
    return results


def dem_scene():
    """One scene of the DEM cell: DEM_SIDE x DEM_SIDE x 1 int16 seeded
    terrain with a quarter sea at -32768 (portbench/rasters/srtm.py)."""
    from portbench.rasters import srtm

    return srtm.scene(DEM_SIDE, DEM_SIDE, np.random.default_rng(3011))


def photo_image():
    """One image of the photo cell: PHOTO_H x PHOTO_W x 3 uint16, a seeded
    linear photograph (portbench/rasters/photo16.py)."""
    from portbench.rasters import photo16

    return photo16.image(PHOTO_H, PHOTO_W, np.random.default_rng(3101))


def k11_phase(dev, card, scene) -> dict:
    """Phase 3: K11 (the step of a quantized encode and the widening to the
    int64 carrier, in one pass) against its twin (api.quantize on the host,
    then the widening) at the DEM cell's two strip shapes, the scene's
    first DEM_ROWS rows and its last 368, at the step DEM_Q with ties toward
    zero: equal outputs; its times, which must be the kernel alone a call,
    again with the L2 cache flushed before each call (a strip's values and
    carriers, 31 MB, fit in the 50 MB L2 and repeated calls read them
    warm), the twin's median and the bound (each value read at 2 bytes and
    its carrier written at 8)."""
    import torch

    from qb3_tpu_torch.benchutil import median_ms
    from qb3_tpu_torch.ops.quantize_cuda import quantize_carrier, quantize_carrier_plain

    res = {}
    tail = DEM_SIDE % DEM_ROWS
    for rows in (scene[:DEM_ROWS], scene[-tail:]):
        label = "i16 {}x{}x{}".format(*rows.shape)
        host = torch.from_numpy(np.ascontiguousarray(rows))
        values = host.to(dev)
        before = quantize_carrier.launches
        got = quantize_carrier(values, 16, True, DEM_Q, False)
        check(quantize_carrier.launches == before + 1, f"K11 {label}: not one launch")
        err = compare("quantize_carrier", got.cpu(),
                      quantize_carrier_plain(host, 16, True, DEM_Q, False))
        call = lambda: quantize_carrier(values, 16, True, DEM_Q, False)  # noqa: E731
        t = launch_times(call, "quantize_kernel")
        check_one_launch(f"K11 {label}", t, "quantize_kernel", memset=False)
        cold = cold_l2_times(call, "quantize_kernel", t["names"])
        plain = median_ms(lambda: quantize_carrier_plain(host, 16, True, DEM_Q, False), 5)
        need = (rows.size * (2 + 8), rows.size * QUANT_OPS)
        bms, by = bound(need)
        log(f"K11 quantize_carrier {label} q {DEM_Q}: equal to the twin; "
            f"{pack_times_text(t)}; {cold_text(cold)}; twin (host NumPy) {plain:.4f} ms; "
            f"bound {bms:.5f} ms by {by} ({need[0]} bytes, {need[1]} operations), "
            f"{100 * bms / t['device_ms']:.1f}% of it warm, "
            f"{100 * bms / cold['device_ms']:.1f}% cold ({card})")
        # the kernels line keeps the full strip's times
        res.setdefault("quantize_carrier", (err, t["ms"], plain, need, None, t["busy_ms"], None))
        del values, got
    return res


def dem_phase(dev, card, kernels, scene) -> int:
    """Phase 5, the DEM cell's encode: the scene through StripEncoder
    (CF_RLE_H, the step DEM_Q, ties toward zero) in pushes of DEM_ROWS rows,
    the launch counts set to 0 just before and read just after, every twin
    refused: K11 once a strip (12), its payload equal to that of the host
    quantizer's route (api.quantize, then the same strip encode at step 1,
    whose header differs in the step alone); host-to-host MB/s of both.
    Returns K11's launches."""
    import qb3_tpu_torch as qt
    from qb3_tpu_torch import api, container
    from qb3_tpu_torch.api import DT_FROM_NP
    from qb3_tpu_torch.benchutil import host_seconds
    from qb3_tpu_torch.constants import Mode

    def encode(x, q):
        enc = qt.StripEncoder(DEM_SIDE, DEM_SIDE, 1, DT_FROM_NP[x.dtype], mode=Mode.CF_RLE_H,
                              quanta=q, strip_rows=DEM_ROWS, device=dev)
        for y in range(0, DEM_SIDE, DEM_ROWS):
            enc.push(x[y: y + DEM_ROWS])
        return enc.finish()

    reset(kernels)
    with no_twins():
        stream = encode(scene, DEM_Q)
    n = kernels["quantize_carrier"].launches
    nstrips = -(-DEM_SIDE // DEM_ROWS)
    check(n == nstrips, f"DEM strips: {n} K11 launches, want {nstrips}")
    want = encode(api.quantize(scene, DEM_Q, False), 1)
    info, plain = container.parse_headers(stream), container.parse_headers(want)
    check(info.quanta == DEM_Q and plain.quanta == 1, "DEM strips: the headers' steps")
    check(stream[info.data_offset:] == want[plain.data_offset:],
          "DEM strips: the payload differs from the host quantizer's route")
    mb = scene.nbytes / 1e6
    t_k11 = host_seconds(lambda: encode(scene, DEM_Q))
    t_host = host_seconds(lambda: encode(api.quantize(scene, DEM_Q, False), 1))
    log(f"DEM strips (i16 {DEM_SIDE}x{DEM_SIDE}x1 CF_RLE_H q {DEM_Q}, {nstrips} strips of "
        f"{DEM_ROWS} rows): K11 launches {n}; payload equal to the host quantizer's route "
        f"({len(stream)} bytes); host to host {mb / t_k11:.2f} MB/s with K11, "
        f"{mb / t_host:.2f} with api.quantize on the host ({card})")
    return n


def photo_phase(dev, card, kernels, photo) -> dict:
    """Phase 5, the photo cell's encode, the launch counts set to 0 just
    before and read just after, every twin refused: the image through
    StripEncoder (FTL, the default core band) in pushes of PHOTO_ROWS rows,
    K8 once a strip (11), K6's stitch entry once, neither K9 nor K1; the
    one-shot encode of the image (api.encode, the image-layout encode of
    the whole image: one more K8), equal to the strip stream; the decode of
    the strip stream on the card (api.decode: the C++ walk, K7, K5b), equal
    to the image.  Then the plain reference's FTL stream
    (portbench/reference/qb3ref.py), equal to the strip stream.  Each run's
    host seconds and peak device memory, and host-to-host MB/s of the strip
    encode.  Returns the launch counts of the phase."""
    import torch

    import qb3_tpu_torch as qt
    from qb3_tpu_torch import api
    from qb3_tpu_torch.benchutil import host_seconds
    from qb3_tpu_torch.constants import DType, Mode
    from portbench.reference import qb3ref

    def strips():
        enc = qt.StripEncoder(PHOTO_W, PHOTO_H, 3, DType.U16, mode=Mode.FTL,
                              strip_rows=PHOTO_ROWS, device=dev)
        for y in range(0, PHOTO_H, PHOTO_ROWS):
            enc.push(photo[y: y + PHOTO_ROWS])
        return enc.finish()

    def measured(fn):
        """fn()'s result, host seconds and peak device bytes above what was
        allocated before it."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, torch.cuda.max_memory_allocated() - base

    nstrips = -(-PHOTO_H // PHOTO_ROWS)
    reset(kernels)
    with no_twins():
        stream, t_strip, peak_strip = measured(strips)
        n = {k: kernels[k].launches for k in ("encode_pack_image", "place_parts",
                                              "phase_a_fast", "pack_groups_chunked")}
        check(n == {"encode_pack_image": nstrips, "place_parts": 1, "phase_a_fast": 0,
                    "pack_groups_chunked": 0},
              f"photo strips: launches {n}, want K8 {nstrips}, K6's stitch 1, no K9 or K1")
        one, t_one, peak_one = measured(lambda: api.encode(photo, device=dev))
        check(one == stream, "photo: the one-shot stream differs from the strip stream")
        del one
        torch.cuda.empty_cache()
        (back, _), t_dec, peak_dec = measured(lambda: api.decode(stream, device=dev))
        check(back.dtype == photo.dtype and np.array_equal(back, photo),
              "photo: the card's decode differs from the image")
        del back
    launches = {k: f.launches for k, f in kernels.items() if f.launches}
    check(launches["encode_pack_image"] == nstrips + 1 and launches.get("gather_slabs", 0) > 0
          and launches.get("wavefront_wide", 0) > 0,
          f"photo: launches {launches}, want K8 {nstrips + 1}, K7 and K5b")
    t0 = time.perf_counter()
    check(qb3ref.encode(photo, qb3ref.FTL) == stream,
          "photo: the strip stream differs from the plain reference's")
    t_ref = time.perf_counter() - t0
    mb = photo.nbytes / 1e6
    t_host = host_seconds(strips, 3)
    log(f"photo strips (u16 {PHOTO_W}x{PHOTO_H}x3 FTL, {nstrips} strips of {PHOTO_ROWS} "
        f"rows, {len(stream)} bytes, ratio {len(stream) / photo.nbytes:.4f}): launches "
        f"{launches}; the strip stream equal to the one-shot encode's, the plain "
        f"reference's ({t_ref:.1f} s on the host) and decoded on the card to the image; "
        f"strips {t_strip:.3f} s (first run) at a peak of {peak_strip / 1e9:.2f} GB, "
        f"host to host {mb / t_host:.2f} MB/s ({t_host:.4f} s); one-shot {t_one:.3f} s at "
        f"{peak_one / 1e9:.2f} GB; decode {t_dec:.3f} s at {peak_dec / 1e9:.2f} GB ({card})")
    return launches


def k1_best_cases(imgs: dict, dev):
    """K1's shapes on the best encode, one at a time: (entry name, tbits,
    the arguments of pack_groups_chunked) for BEST_K1's rasters, phase A
    (encode_best_blocks) run on the card."""
    import torch

    from qb3_tpu_torch import api
    from qb3_tpu_torch.constants import HILBERT
    from qb3_tpu_torch.ops import bitpack
    from qb3_tpu_torch.ops.encode_best import encode_best_blocks

    for name, label in BEST_K1.items():
        x = imgs[label]
        (h, w, nb), tb = x.shape, 8 * x.itemsize
        zero = torch.zeros(nb, dtype=torch.int64, device=dev)
        codes, lens = encode_best_blocks(api.to_carrier(x, dev), zero, zero, zero, HILBERT,
                                         tuple(api.default_cband(nb)), tb)[:2]
        yield name, tb, (codes, lens, api.stream_words(w, h, nb, api.DT_FROM_NP[x.dtype]),
                         bitpack.group_bits_bound(tb, best=True))


def k1_best_phase(dev, card, imgs: dict) -> dict:
    """Phase 3h: K1 against its twin at the best encode's shapes (S = 27 at
    u8, 43 at u64), with the median, the device ms and ops of a call (the
    kernel and at most one memset), the twin's median and the bound."""
    from qb3_tpu_torch.benchutil import median_ms
    from qb3_tpu_torch.ops import bitpack, pack_cuda

    results = {}
    for name, tb, args in k1_best_cases(imgs, dev):
        codes, lens = args[:2]
        check(codes.shape[-1] == (43 if tb == 64 else 27), f"{name}: {codes.shape[-1]} symbols")
        got = pack_cuda.pack_groups_chunked(*args)
        err = compare(name, got, bitpack.pack_groups(*args))
        ngroups, placed = lens.numel() // lens.shape[-1], int((lens > 0).sum())
        need = (codes.numel() * CODE_BYTES[tb] + lens.numel() + 2 * ngroups
                + stream_bytes(got[1]) + nbytes(got[1]),
                placed * PLACE_OPS * wide(tb) + ngroups * GROUP_OPS)
        t1 = launch_times(lambda: pack_cuda.pack_groups_chunked(*args), "pack_groups_kernel")
        check_one_launch(f"K1 {name}", t1, "pack_groups_kernel")
        plain = median_ms(lambda: bitpack.pack_groups(*args), 5)
        bms, by = bound(need)
        log(f"K1 pack_groups_chunked best {BEST_K1[name]} CF_H codes {tuple(codes.shape)}: equal; "
            f"{pack_times_text(t1)}; twin {plain:.4f} ms; bound {bms:.5f} ms by {by} "
            f"({need[0]} bytes, {need[1]} operations); {placed} of {lens.numel()} symbols "
            f"placed ({card})")
        results[name] = (err, t1["ms"], plain, need, None, t1["busy_ms"], None)
        del codes, lens, args, got
    return results


def kernel_phase(dev, card, img, tiles, u16):
    """Phase 3: each kernel against its twin at the main path's shapes."""
    import torch

    from qb3_tpu_torch.benchutil import median_ms
    from qb3_tpu_torch.ops import bitpack, pack_cuda
    from qb3_tpu_torch.ops.chunkwalk_cuda import chunkwalk8, chunkwalk8_plain

    results = {}
    for label, args in k1_cases(img, tiles, dev):
        codes, lens = args[:2]
        got = pack_cuda.pack_groups_chunked(*args)
        err = compare("pack_groups_chunked", got, bitpack.pack_groups(*args))
        ngroups, placed = lens.numel() // lens.shape[-1], int((lens > 0).sum())
        need = (codes.numel() * CODE_BYTES[8] + lens.numel() + 2 * ngroups
                + stream_bytes(got[1]) + nbytes(got[1]),
                placed * PLACE_OPS * wide(8) + ngroups * GROUP_OPS)
        t1 = launch_times(lambda: pack_cuda.pack_groups_chunked(*args), "pack_groups_kernel")
        check_one_launch(f"K1 {label}", t1, "pack_groups_kernel")
        plain = median_ms(lambda: bitpack.pack_groups(*args), 5)
        bms, by = bound(need)
        log(f"K1 pack_groups_chunked {label} codes {tuple(codes.shape)}: equal; "
            f"{pack_times_text(t1)}; twin {plain:.4f} ms; bound {bms:.5f} ms by {by}; the "
            f"int64 carriers weigh {nbytes(codes, lens)} bytes ({card})")
        if "pack_groups_chunked" in results:  # keep the first shape's times
            err = max(err, results["pack_groups_chunked"][0])
            results["pack_groups_chunked"] = (err,) + results["pack_groups_chunked"][1:]
        else:
            results["pack_groups_chunked"] = (err, t1["ms"], plain, need, None, t1["busy_ms"],
                                              None)
        del codes, lens, args

    for label, streams, ubits in k3_cases(img, tiles, u16, dev):
        a = walk_inputs(streams, dev)
        wargs = (a["words32"], a["wrow"], a["R"])
        win = pack_cuda.extract_windows(*wargs)
        err3 = compare("extract_windows", win, pack_cuda.extract_windows_plain(*wargs))
        take = take_windows(a["words32"], a["wrow"].to(torch.int64) * 128, a["R"])
        compare("extract_windows", take(), win)
        t3 = launch_times(lambda: pack_cuda.extract_windows(*wargs), "extract_windows_kernel")
        tt = launch_times(take)
        plain3 = median_ms(lambda: pack_cuda.extract_windows_plain(*wargs), 5)
        need3 = (2 * nbytes(win), 0)
        bms, by = bound(need3)
        log(f"K3 extract_windows {label} windows {tuple(win.shape)}: equal; kernel "
            f"{times_text(t3)}; torch.take {times_text(tt)}; twin {plain3:.4f} ms; bound "
            f"{bms:.5f} ms by {by} ({card})")
        cargs = (a["words32"], win, a["wrow"], a["starts"], a["entry"], a["k"],
                 a["nb"], False, ubits)
        walked = chunkwalk8(*cargs)
        err2 = compare("chunkwalk8", walked, chunkwalk8_plain(*cargs))
        t2 = launch_times(lambda: chunkwalk8(*cargs), "chunkwalk")
        check_one_launch(f"K2 {label}", t2, "chunkwalk", memset=False)
        plain2 = median_ms(lambda: chunkwalk8_plain(*cargs), 3)
        tbits = 8 if ubits == 3 else 16
        need2 = (payload_bytes(streams) + 4 * a["starts"].numel() + a["entry"].numel()
                 + walked.numel() * tbits // 8, walk_ops(walked, tbits))
        bms, by = bound(need2)
        log(f"K2 chunkwalk8 {label} ubits {ubits} chunks {a['starts'].shape[0]}: equal; "
            f"{pack_times_text(t2)}; twin {plain2:.4f} ms; bound {bms:.5f} ms by {by} ({card})")
        results.setdefault("extract_windows", (err3, t3["ms"], plain3, need3, tt["ms"],
                                               t3["device_ms"], tt["device_ms"]))
        results.setdefault("chunkwalk8", (err2, t2["ms"], plain2, need2, None, t2["busy_ms"],
                                          None))
        del walked, take, win
    return results


def ix_cases():
    """The "ix" shapes: label -> (N, H, W, C) tiles (N = 1: one image)."""
    from qb3_tpu_torch.benchutil import headline_image

    def tiles(n, h, w, c, dtype, seed):
        return np.stack([headline_image(h, w, c, seed=seed + i, dtype=dtype) for i in range(n)])

    return {
        "u8 512x512x3": tiles(1, 512, 512, 3, np.uint8, 42),
        f"u8 512x512x3 batch{BATCH}": tiles(BATCH, 512, 512, 3, np.uint8, 100),
        "u16 1024x1024x1": tiles(1, 1024, 1024, 1, np.uint16, 7),
        "u16 512x512x8": tiles(1, 512, 512, 8, np.uint16, 11),
        "u32 1024x1024x1": tiles(1, 1024, 1024, 1, np.uint32, 12),
        "u64 1024x1024x1": tiles(1, 1024, 1024, 1, np.uint64, 13),
        "u64 1024x1024x1 batch8": tiles(8, 1024, 1024, 1, np.uint64, 200),
    }


def ix_inputs(streams, dev):
    """Device inputs of the "ix" decode of one stream or a same-shape batch
    (decode_tiles' flat tile layout), with K4's sizes and the group starts."""
    import torch

    from qb3_tpu_torch import api, container
    from qb3_tpu_torch.batch import _flat_tile_layout
    from qb3_tpu_torch.constants import TYPESIZES
    from qb3_tpu_torch.ops.decode import payload_words

    infos = [container.parse_headers(s) for s in streams]
    i0 = infos[0]
    tbits = 8 * TYPESIZES[i0.dtype]
    glens = np.stack([np.frombuffer(i.index, "<u2").astype(np.int32) for i in infos])
    if len(streams) == 1:
        words, tw32 = api.padded_words(streams[0][i0.data_offset:]), 0
    else:
        words, tw32 = _flat_tile_layout(
            [payload_words(s[i.data_offset:]) for s, i in zip(streams, infos)])
    nreg, R = api._fused_ix_params(glens, tbits, tw32)
    goff = (np.cumsum(glens.astype(np.int64), axis=1) - glens
            + np.arange(len(streams))[:, None] * tw32 * 32).reshape(-1)
    return dict(words32=torch.from_numpy(words.reshape(-1).view(np.int32)).to(dev),
                glens=torch.from_numpy(glens.reshape(-1)).to(dev),
                goff=torch.from_numpy(goff.astype(np.int32)).to(dev), nreg=nreg, R=R,
                tbits=tbits, nb=i0.nbands, h=i0.ysize, w=i0.xsize, cband=tuple(i0.cband),
                nblocks=glens.shape[1] // i0.nbands, ntiles=len(streams), tw32=tw32,
                per_tile=glens.shape[1])


def ix_kernel_phase(dev, card, cases):
    """Phase 3b: K4 (both modes), K5a and K5b against their twins at the
    "ix" shapes.  Returns (per-kernel results, {label: streams})."""
    from qb3_tpu_torch import batch
    from qb3_tpu_torch.benchutil import median_ms
    from qb3_tpu_torch.ops.fusedwin_cuda import wavefront_fused, wavefront_fused_plain

    results, all_streams = {}, {}
    for label, tiles in cases.items():
        streams = batch.encode_tiles(tiles, index=True, device=dev)
        all_streams[label] = streams
        a = ix_inputs(streams, dev)
        tb, nreg = a["tbits"], a["nreg"]
        k4 = (a["words32"], a["goff"], nreg, a["R"], tb)
        kw = dict(nbands=a["nb"], per_tile=a["per_tile"])
        walked = wavefront_fused(*k4, **kw)
        err4 = compare("wavefront_fused", walked, wavefront_fused_plain(*k4[:3], tb, **kw))
        ng = a["goff"].numel()
        need4 = (payload_bytes(streams) + ng * (4 + 16 * tb // 8 + 1),
                 walk_ops(walked[0], tb))
        t4 = launch_times(lambda: wavefront_fused(*k4, **kw), "fused_kernel")
        check_one_launch(f"K4 {label}", t4, "fused_kernel")
        ms4 = t4["ms"]
        plain4 = median_ms(lambda: wavefront_fused_plain(*k4[:3], tb, **kw), 3)
        bms, by = bound(need4)
        log(f"K4 wavefront_fused {label}: {pack_times_text(t4)}; bound {bms:.5f} ms by {by} "
            f"({card})")
        case = k5_ix_case(streams, dev)
        given = {k: case[k] for k in ("off", "rung", "kind")}
        err4 = max(err4, compare("wavefront_fused", wavefront_fused(*k4, **given),
                                 wavefront_fused_plain(*k4[:3], tb, **given)))
        log(f"K4 wavefront_fused {label} groups {a['goff'].shape[0]} nreg {nreg} R {a['R']}: "
            f"equal in both modes, kernel {ms4:.4f} ms, twin {plain4:.4f} ms")
        name, res5 = k5_time(f"ix {label}", case, card)
        for kname, res in (("wavefront_fused", (err4, ms4, plain4, need4, None,
                                                t4["busy_ms"], None)), (name, res5)):
            if kname in results:  # keep the first shape's times, the worst error
                res = (max(res[0], results[kname][0]),) + results[kname][1:]
            results[kname] = res
        del case, given, walked
    return results, all_streams


def walk_edge_phase(dev, card) -> dict:
    """Phase 3g: K4 (both modes, at its staged span and at a span of 64
    words that most windows leave) and K2 against their twins on the edge
    inputs of tests/walk_edges.py: tiles that start inside a block, long
    tiles, blocks of several rounds, 1 to 256 bands, damaged lengths,
    corrupt chunks, every width.  Returns each kernel's largest error."""
    import torch

    from qb3_tpu_torch.api import _fused_ix_params
    from qb3_tpu_torch.ops.chunkwalk_cuda import chunkwalk8, chunkwalk8_plain
    from qb3_tpu_torch.ops.decode import ix_parse, ix_regs
    from qb3_tpu_torch.ops.fusedwin_cuda import wavefront_fused, wavefront_fused_plain
    from qb3_tpu_torch.ops.pack_cuda import extract_windows
    from tests import walk_edges

    err = {"wavefront_fused": 0, "chunkwalk8": 0}
    for name in walk_edges.K4_CASES:
        words32, glens, tbits, nb, nblocks, ntiles, tw32, step = walk_edges.k4_case(name)
        nreg, R = _fused_ix_params(glens.reshape(ntiles, -1), tbits, tw32)
        per_tile = nblocks * nb
        g2 = glens.reshape(ntiles, per_tile).astype(np.int64)
        goff = np.cumsum(g2, 1) - g2 + np.arange(ntiles)[:, None] * tw32 * 32
        w = torch.from_numpy(words32).to(dev)
        go = torch.from_numpy(goff.reshape(-1).astype(np.int32)).to(dev)
        off, rung, kind = (x.to(torch.int32) for x in
                           ix_parse(ix_regs(w, go, nreg), go, tbits, nb, per_tile))
        for kw in (dict(nbands=nb, per_tile=per_tile), dict(off=off, rung=rung, kind=kind)):
            want = wavefront_fused_plain(w, go, nreg, tbits, apply_step=step, **kw)
            for r in (R, 64):
                err["wavefront_fused"] = max(err["wavefront_fused"], compare(
                    f"wavefront_fused {name}",
                    wavefront_fused(w, go, nreg, r, tbits, apply_step=step, **kw), want))
        log(f"K4 edge {name}: {go.numel()} groups, {nb} bands, tiles of {per_tile}: equal in "
            f"both modes at spans of {R} and 64 words")
    for name in walk_edges.K2_CASES:
        words32, starts, entry, ubits, nb, k, step, maxw, R = walk_edges.k2_case(name)
        w, st, en = (torch.from_numpy(x).to(dev) for x in (words32, starts, entry))
        wrow = (st[::128] >> 5) >> 7
        args = (w, extract_windows(w, wrow, R), wrow, st, en, k, nb, step, ubits)
        err["chunkwalk8"] = max(err["chunkwalk8"], compare(f"chunkwalk8 {name}",
                                                           chunkwalk8(*args),
                                                           chunkwalk8_plain(*args)))
        log(f"K2 edge {name}: {st.numel()} chunks, {nb} bands, ubits {ubits}: equal")
    return err


def n_words_for(x) -> int:
    """The encoder's stream buffer in words for raster x, as api.Encoder
    sizes it."""
    from qb3_tpu_torch import api

    h, w, nb = x.shape
    return api.stream_words(w, h, nb, api.DT_FROM_NP[x.dtype])


def k8_cases(dev):
    """K8's shapes, one at a time: (label, skipstep, raster, phase A's
    result, the arguments of encode_pack_image) at the four wide shapes
    (FTL) and u64 1024x1024x1 BASE, Hilbert curve."""
    from qb3_tpu_torch import api
    from qb3_tpu_torch.benchutil import WIDE_IMAGES, wide_image
    from qb3_tpu_torch.constants import HILBERT
    from qb3_tpu_torch.ops.encode_cuda import image_pack_args
    from qb3_tpu_torch.ops.encode_image import phase_a_image

    for label, skipstep in [(k, True) for k in WIDE_IMAGES] + [("u64 1024x1024x1", False)]:
        x = wide_image(label)
        nb = x.shape[2]
        zero = api.to_carrier(np.zeros(nb, x.dtype), dev)
        o = phase_a_image(api.to_carrier(x, dev), zero, zero, HILBERT,
                          tuple(api.default_cband(nb)), skipstep, 8 * x.itemsize)
        yield label, skipstep, x, o, image_pack_args(o, 8 * x.itemsize, n_words_for(x), HILBERT)


def k8_phase(dev, card):
    """Phase 3c: K8 against its twin at the wide shapes (FTL, Hilbert) and
    u64 BASE, with each shape's median, device ms, device ops a call and
    host enqueue."""
    from qb3_tpu_torch.benchutil import median_ms
    from qb3_tpu_torch.ops.encode_cuda import encode_pack_image, encode_pack_image_plain

    res = None
    for label, skipstep, x, o, args in k8_cases(dev):
        words, total, glen = encode_pack_image(*args)
        pw, pt, pg = encode_pack_image_plain(*args)
        used = (int(pt) + 31) // 32
        err = compare("encode_pack_image", (words[:used], total, glen), (pw[:used], pt, pg))
        t8 = launch_times(lambda: encode_pack_image(*args), "encode_pack_image_kernel")
        check_one_launch(f"K8 {label}", t8, "encode_pack_image_kernel")
        plain = median_ms(lambda: encode_pack_image_plain(*args), 5)
        ng = glen.numel()
        need = k8_need(x, args, total, ng)
        bms, by = bound(need)
        log(f"K8 encode_pack_image {label} {'FTL' if skipstep else 'BASE'} groups "
            f"{ng} max rung {int(o['rung'].max())}: equal; {pack_times_text(t8)}; "
            f"twin {plain:.4f} ms, bound {bms:.4f} ms by {by} ({need[0]} bytes, "
            f"{need[1]} integer operations; the int64 carriers move "
            f"{nbytes(*args[:6]) + stream_bytes(total)} bytes) ({card})")
        res = ((max(err, res[0]),) + res[1:] if res
               else (err, t8["ms"], plain, need, None, t8["busy_ms"], None))
        del o, args, words, pw
    return {"encode_pack_image": res}


def k8_need(x, args, total, ng: int) -> tuple:
    """K8's (bytes, integer operations) on raster x in ng groups, args those
    of encode_pack_image: each value read at its width, each group's kind
    and length, the stream and its total written once; each coded value's
    code and place, each one-bit value's place, each group's prefix."""
    tb, gkind = 8 * x.itemsize, args[2]
    return (x.nbytes + ng * (7 + 2) + stream_bytes(total) + nbytes(total),
            16 * (int((gkind == 0).sum()) * (CODE_OPS + PLACE_OPS) * wide(tb)
                  + int((gkind == 1).sum()) * PLACE_OPS) + ng * GROUP_OPS)


def k8_photo_phase(dev, card, photo) -> dict:
    """Phase 3c: K8 against its twin at the photo cell's two strip shapes,
    the image's first PHOTO_ROWS rows and its last 292 (FTL, Hilbert, the
    default core band, phase A from a zero band state, as the first strip
    starts): equal outputs, one launch a call, which must be the kernel and
    at most one memset, the twin's median and the bound.  The kernels
    line's entry PHOTO_K8 keeps the full strip's times."""
    import torch

    from qb3_tpu_torch import api
    from qb3_tpu_torch.benchutil import median_ms
    from qb3_tpu_torch.constants import HILBERT
    from qb3_tpu_torch.ops.encode_cuda import (encode_pack_image, encode_pack_image_plain,
                                               image_pack_args)
    from qb3_tpu_torch.ops.encode_image import phase_a_image

    res = {}
    zero = torch.zeros(3, dtype=torch.int64, device=dev)
    for rows in (photo[:PHOTO_ROWS], photo[-(PHOTO_H % PHOTO_ROWS):]):
        label = "u16 {}x{}x{}".format(*rows.shape)
        o = phase_a_image(api.to_carrier(rows, dev), zero, zero, HILBERT,
                          tuple(api.default_cband(3)), True, 16)
        args = image_pack_args(o, 16, n_words_for(rows), HILBERT)
        before = encode_pack_image.launches
        words, total, glen = encode_pack_image(*args)
        check(encode_pack_image.launches == before + 1, f"K8 photo {label}: not one launch")
        pw, pt, pg = encode_pack_image_plain(*args)
        used = (int(pt) + 31) // 32
        err = compare(PHOTO_K8, (words[:used], total, glen), (pw[:used], pt, pg))
        t8 = launch_times(lambda: encode_pack_image(*args), "encode_pack_image_kernel")
        check_one_launch(f"K8 photo {label}", t8, "encode_pack_image_kernel")
        plain = median_ms(lambda: encode_pack_image_plain(*args), 3)
        need = k8_need(rows, args, total, glen.numel())
        bms, by = bound(need)
        log(f"K8 encode_pack_image photo {label} FTL groups {glen.numel()} bits {int(total)} "
            f"max rung {int(o['rung'].max())}: equal; {pack_times_text(t8)}; twin {plain:.4f} ms, "
            f"bound {bms:.4f} ms by {by} ({need[0]} bytes, {need[1]} integer operations), "
            f"{100 * bms / t8['device_ms']:.1f}% of it ({card})")
        res.setdefault(PHOTO_K8, (err, t8["ms"], plain, need, None, t8["busy_ms"], None))
        del o, args, words, pw
    return res


def stream_walk(stream, dev):
    """A stream without a sidecar (any mode, 4-aligned), the host walk of
    its payload and decode_groups' device inputs."""
    from qb3_tpu_torch import api, container, rle
    from qb3_tpu_torch.constants import TYPESIZES, needs_rle

    info = container.parse_headers(stream)
    check(info.index is None and info.index_chunked is None and info.index_best is None,
          "a walk stream has a sidecar")
    data = stream[info.data_offset:]
    if needs_rle(info.mode):
        data = rle.rle0_decode(data, rle.rle0_decoded_size(data))
    tsize = TYPESIZES[info.dtype]
    nblocks = (info.ysize // 4) * (info.xsize // 4)
    meta, path = api.walk_offsets(data, nblocks, info.nbands, tsize, info.mode)
    return dict(stream=stream, info=info, data=data, meta=meta, path=path, nblocks=nblocks,
                inp=api.walk_inputs(meta, api.padded_words(data), 8 * tsize, dev))


def kind_counts(kind) -> dict:
    """The walk's kinds (offsets.KIND_*) counted by name."""
    names = ("NORMAL", "ZERO", "BITS", "CF", "CF0", "IDX")
    counts = np.bincount(np.asarray(kind).reshape(-1), minlength=6)
    return {n: int(c) for n, c in zip(names, counts)}


def k5_kernel(tbits: int):
    """(name, wrapper, twin) of K5a (u8) or K5b (u16 / u32 / u64)."""
    from qb3_tpu_torch.ops.wavefront_cuda import (wavefront8, wavefront8_plain,
                                                  wavefront_wide, wavefront_wide_plain)

    if tbits == 8:
        return "wavefront8", wavefront8, wavefront8_plain
    return "wavefront_wide", wavefront_wide, wavefront_wide_plain


def k5_args(case: dict) -> tuple:
    """A K5 case's arguments: regs, off, rung, kind, nreg, tbits for K5b, cf."""
    wide_ = (case["tbits"],) if case["tbits"] > 8 else ()
    return (case["regs"], case["off"], case["rung"], case["kind"], case["nreg"], *wide_,
            case["cf"])


def k5_ix_case(streams, dev) -> dict:
    """K5's inputs on the K5 branch of the "ix" decode (decode_indexed_narrow
    without K4's span) of one stream or a same-shape batch: the windows
    gathered by indexing, at the sidecar's narrowed nreg, and the parse."""
    import torch

    from qb3_tpu_torch.ops.decode import ix_parse, ix_regs

    a = ix_inputs(streams, dev)
    regs = ix_regs(a["words32"], a["goff"], a["nreg"])
    off, rung, kind = (x.to(torch.int32) for x in
                       ix_parse(regs, a["goff"], a["tbits"], a["nb"], a["per_tile"]))
    return dict(regs=regs[:, :a["nreg"]].to(torch.int32).contiguous(), off=off, rung=rung,
                kind=kind, nreg=a["nreg"], tbits=a["tbits"], cf=None)


def k5_walk_case(inp: dict, tbits: int) -> dict:
    """K5's inputs in decode_groups (a walk or an "ib" sidecar): the windows
    K7 gathers from decode_groups' arguments inp."""
    from qb3_tpu_torch.ops.gather_cuda import gather_slabs

    return dict(regs=gather_slabs(inp["words32"], inp["base"], inp["nreg"], inp["R"]),
                off=inp["off"], rung=inp["rung"], kind=inp["kind"], nreg=inp["nreg"],
                tbits=tbits, cf=inp["cf"])


def best_ib_case(streams, dev) -> tuple:
    """decode_groups' inputs of best-mode "ib" streams, one (padded as the
    Decoder pads it) or a same-shape batch in decode_tiles' flat tile
    layout, and their kinds -> (inputs, kinds, tbits)."""
    from qb3_tpu_torch import api, container
    from qb3_tpu_torch.batch import _flat_tile_layout, ib_meta
    from qb3_tpu_torch.constants import TYPESIZES
    from qb3_tpu_torch.ops.decode import payload_words

    infos = [container.parse_headers(s) for s in streams]
    i0 = infos[0]
    check(all(i.index_best is not None for i in infos), "a best stream lacks its ib sidecar")
    if len(streams) == 1:
        words, tile_words32 = api.padded_words(streams[0][i0.data_offset:]), 0
    else:
        words, tile_words32 = _flat_tile_layout(
            [payload_words(s[i.data_offset:]) for s, i in zip(streams, infos)])
    ngroups = ((i0.ysize + 3) // 4) * ((i0.xsize + 3) // 4) * i0.nbands
    meta = ib_meta([api._parse_best_sidecar(i.index_best, ngroups) for i in infos],
                   tile_words32)
    tb = 8 * TYPESIZES[i0.dtype]
    return api.walk_inputs(meta, words.reshape(-1), tb, dev), meta["kind"], tb


def best_ib_streams(dev, tiles) -> dict:
    """The best modes' "ib" decode inputs of phase 5: label -> streams (the
    u8 512x512x3 headline and the u64 1024x1024x1 raster in CF_H, and the
    BATCH tiles' batch)."""
    import qb3_tpu_torch as qt
    from qb3_tpu_torch.benchutil import headline_image, wide_image
    from qb3_tpu_torch.constants import Mode

    return {"u8 512x512x3 CF_H": [qt.encode(headline_image(), mode=Mode.CF_H, index=True,
                                            device=dev)],
            "u64 1024x1024x1 CF_H": [qt.encode(wide_image("u64 1024x1024x1"), mode=Mode.CF_H,
                                               index=True, device=dev)],
            f"u8 512x512x3 CF_H batch{BATCH}": qt.encode_tiles(tiles, mode=Mode.CF_H,
                                                                index=True, device=dev)}


def strip_read_case(stream, dev) -> dict:
    """K5's inputs of a StripDecoder's first STRIP_ROWS-row read of stream:
    decode_groups' arguments as strip.py passes them, caught on the way."""
    import qb3_tpu_torch as qt
    from qb3_tpu_torch import strip

    seen, real = [], strip.decode_groups

    def catch(words32, **kw):
        seen.append(dict(kw, words32=words32))
        return real(words32, **kw)

    strip.decode_groups = catch
    try:
        qt.StripDecoder(stream, strip_rows=STRIP_ROWS, device=dev).read(STRIP_ROWS)
    finally:
        strip.decode_groups = real
    return k5_walk_case(seen[0], seen[0]["tbits"])


def k5_need(walked, case: dict):
    """(bytes, integer operations) K5 needs on a case: the windows, the
    per-group off, rung, kind (and cf where given) read once and the values
    written once at the type's width; 16 decodes a coded group (walk_ops),
    a decode per IDX group's unique (its distinct values), and the CF
    multiply-back (3 a value) or CF0 expansion (1 a value)."""
    import torch

    kind, tb = case["kind"], case["tbits"]
    ng = kind.numel()
    vals = walked.reshape(-1, 16).to(torch.int64)
    idx = kind == 5
    srt = vals[idx].sort(-1).values
    uniques = int(idx.sum()) + int((srt[:, 1:] != srt[:, :-1]).sum())
    ops = (walk_ops(walked, tb) + uniques * DECODE_OPS * wide(tb)
           + 16 * (3 * int((kind == 3).sum()) + int((kind == 4).sum())))
    cf_bytes = 0 if case["cf"] is None else 8
    return (nbytes(case["regs"]) + ng * (2 + 1 + 1 + cf_bytes) + ng * 16 * tb // 8, ops)


def k5_time(label: str, case: dict, card: str, note: str = "") -> tuple:
    """K5a or K5b on one case: equal to its twin (tolerance zero), one
    kernel a call and nothing else, its times (launch_times: median, device
    ms, ops a call, enqueue us), the twin's and the bound, logged ->
    (name, the kernels line's entry)."""
    from qb3_tpu_torch.benchutil import median_ms

    name, kern, plain = k5_kernel(case["tbits"])
    args = k5_args(case)
    got = kern(*args)
    err = compare(f"{name} {label}", got, plain(*args))
    t = launch_times(lambda: kern(*args), f"{name}_kernel")
    check_one_launch(f"K5 {name} {label}", t, f"{name}_kernel", memset=False)
    plain_ms = median_ms(lambda: plain(*args), 3)
    need = k5_need(got, case)
    bms, by = bound(need)
    log(f"K5 {name} {label}, {case['kind'].numel()} groups, nreg {case['nreg']}{note}: equal; "
        f"{pack_times_text(t)}; twin {plain_ms:.4f} ms; bound {bms:.5f} ms by {by} "
        f"({need[0]} bytes, {need[1]} integer operations) ({card})")
    return name, (err, t["ms"], plain_ms, need, None, t["busy_ms"], None)


def k7_phase(dev, card, img, u64, best):
    """Phase 3d: K7 against its twin at the windows the walk decode gathers
    (the headline u8 tile and u64 1024x1024x1) and the best batch's "ib"
    decode (best: best_ib_streams' dict)."""
    from qb3_tpu_torch.benchutil import median_ms
    from qb3_tpu_torch.ops.gather_cuda import gather_slabs, gather_slabs_plain

    res = None
    batch = f"u8 512x512x3 CF_H batch{BATCH}"
    for label, a in (("u8 512x512x3", k7_inputs(img, dev)),
                     ("u64 1024x1024x1", k7_inputs(u64, dev)),
                     (f"ib {batch}", best_ib_case(best[batch], dev)[0])):
        words32, base, W, R = a["words32"], a["base"], a["nreg"], a["R"]
        got = gather_slabs(words32, base, W, R)
        err = compare("gather_slabs", got, gather_slabs_plain(words32, base, W))
        take = take_windows(words32, base, W)
        compare("gather_slabs", take(), got)
        t7 = launch_times(lambda: gather_slabs(words32, base, W, R), "gather_slabs_kernel")
        tt = launch_times(take)
        plain = median_ms(lambda: gather_slabs_plain(words32, base, W), 5)
        ng, n32 = base.numel(), words32.numel()
        lo, hi = int(base.min()), min(int(base.max()) + W, n32)
        need = (4 * ng + 4 * max(hi - lo, 0) + nbytes(got), 2 * got.numel())
        bms, by = bound(need)
        log(f"K7 gather_slabs {label} groups {ng} x {W} words, span R {R}: equal; "
            f"kernel {times_text(t7)}; torch.take {times_text(tt)}; twin {plain:.4f} ms; bound "
            f"{bms:.5f} ms by {by} ({need[0]} bytes) ({card})")
        res = (max(err, res[0]),) + res[1:] if res else (
            err, t7["ms"], plain, need, tt["ms"], t7["device_ms"], tt["device_ms"])
        del got, take, a
    return {"gather_slabs": res}


def k5_decode_cases(dev, best):
    """K5's launch shapes on the decodes that gather windows with K7, one at
    a time: (label, case, the walk's kinds or None).  Best-mode kinds: the
    Landsat sample's walk groups (u16), the groups of a damaged 512x512x3
    BASE_H stream (one bit flipped where the walk meets CF, CF0 or IDX
    groups; u8), seeded random u32 / u64 windows with every kind, rung and
    cf in the domain; the seven walk decodes of phase 5 (the default
    encode's streams: u8 512x512x3 FTL, BASE_Z and RLE_H with a no-data
    rectangle, the four wide images in FTL); a StripDecoder read of each
    strip scene (u8 4096x4096x3 FTL without a sidecar, u16 4096x4096x1
    BASE_H with "ix", which strip reads walk as well); the walk of the
    whole u8 scene; the best modes' "ib" decodes (best: best_ib_streams'
    dict) and a best StripDecoder read of the u16 raster in CF_H."""
    import torch

    import qb3_tpu_torch as qt
    from qb3_tpu_torch import api
    from qb3_tpu_torch.benchutil import (LANDSAT_SAMPLE, WIDE_IMAGES, headline_image,
                                         wide_image)
    from qb3_tpu_torch.constants import Mode

    with open(os.path.join(ROOT, LANDSAT_SAMPLE), "rb") as f:
        c = stream_walk(f.read(), dev)
    yield "u16 Landsat sample 512x512x8 CF_H", k5_walk_case(c["inp"], 16), c["meta"]["kind"]
    img = headline_image()
    stream = api.encode(img, mode=Mode.BASE_H, device=dev)
    info = api.container.parse_headers(stream)
    n = len(stream) - info.data_offset
    for pct in range(50, 100):  # the first flip from the middle on whose walk meets them
        at = info.data_offset + n * pct // 100
        c = stream_walk(stream[:at] + bytes([stream[at] ^ 1]) + stream[at + 1:], dev)
        if (np.asarray(c["meta"]["kind"]) > 2).any():
            break
    check((np.asarray(c["meta"]["kind"]) > 2).any(), "no flip of the BASE_H stream met "
          "best-mode groups")
    yield (f"u8 512x512x3 BASE_H, bit {at * 8} flipped ({pct}%)", k5_walk_case(c["inp"], 8),
           c["meta"]["kind"])
    for tb, nreg in ((32, 20), (64, 36)):
        rng = np.random.default_rng(tb)
        ng = 65536
        kind = rng.integers(0, 6, ng)
        t = torch.from_numpy(np.stack([rng.integers(0, 64, ng), rng.integers(0, tb, ng),
                                       api.K5_KIND[kind]]).astype(np.int32)).to(dev)
        words = rng.integers(0, 1 << 32, (ng + 64) * nreg, dtype=np.uint64).astype(np.uint32)
        base = np.arange(ng, dtype=np.int32) * nreg
        inp = dict(words32=torch.from_numpy(words.view(np.int32)).to(dev),
                   base=torch.from_numpy(base).to(dev), off=t[0], rung=t[1], kind=t[2],
                   nreg=nreg, R=api.gather_span(base, nreg),
                   cf=torch.from_numpy(rng.integers(0, 1 << 64, ng, dtype=np.uint64)
                                       .view(np.int64)).to(dev))
        yield f"u{tb} random windows", k5_walk_case(inp, tb), kind
    nodata = img.copy()
    nodata[64:320, 96:448] = 0  # as walk_phase's
    walks = {"u8 512x512x3 FTL": (img, Mode.FTL), "u8 512x512x3 BASE_Z": (img, Mode.BASE_Z),
             "u8 512x512x3 no-data RLE_H": (nodata, Mode.RLE_H),
             **{label: (wide_image(label), Mode.FTL) for label in WIDE_IMAGES}}
    for label, (x, mode) in walks.items():
        c = stream_walk(qt.encode(x, mode=mode, device=dev), dev)
        yield f"walk {label}", k5_walk_case(c["inp"], 8 * x.itemsize), None
    for label, (x, mode, indexes) in strip_cases().items():
        s = qt.encode(x, mode=mode, index=indexes[0], device=dev)
        side = {False: "no sidecar", True: "ix"}.get(indexes[0], indexes[0])
        yield (f"strip read {label} {side}, {STRIP_ROWS} rows",
               strip_read_case(s, dev), None)
        if x.itemsize == 1:
            c = stream_walk(s, dev)
            yield f"walk {label} scene", k5_walk_case(c["inp"], 8), None
        else:
            s = qt.encode(x, mode=Mode.CF_H, index=True, device=dev)
            yield (f"best strip read u16 4096x4096x1 CF_H ib, {STRIP_ROWS} rows",
                   strip_read_case(s, dev), None)
        del s
    for label, streams in best.items():
        inp, kind, tb = best_ib_case(streams, dev)
        yield f"ib {label}", k5_walk_case(inp, tb), kind
        del inp


def k5_edge_cases(dev):
    """The edge inputs of tests/k5_edges.py on the card: (name, case)."""
    import torch

    from tests import k5_edges

    for name in k5_edges.CASES:
        regs, off, rung, kind, nreg, tbits, cf = k5_edges.k5_case(name)
        t = {k: torch.from_numpy(v).to(dev) for k, v in
             dict(regs=regs, off=off, rung=rung, kind=kind).items()}
        yield name, dict(t, nreg=nreg, tbits=tbits,
                         cf=None if cf is None else torch.from_numpy(cf).to(dev))


def k5_phase(dev, card, best) -> dict:
    """Phase 3d: K5a and K5b at every launch shape of the decodes that
    gather windows (k5_decode_cases), each against its twin with its times
    and bound (k5_time), then on the edge inputs of tests/k5_edges.py
    against the twins, tolerance zero.  Returns {kernel: max abs err}."""
    errs = {}
    for label, case, kind in k5_decode_cases(dev, best):
        note = "" if kind is None else f", kinds {kind_counts(kind)}"
        name, res = k5_time(label, case, card, note)
        errs[name] = max(errs.get(name, 0), res[0])
        del case
    for label, case in k5_edge_cases(dev):
        name, kern, plain = k5_kernel(case["tbits"])
        args = k5_args(case)
        errs[name] = max(errs.get(name, 0), compare(f"{name} edge {label}", kern(*args),
                                                    plain(*args)))
        log(f"K5 {name} edge {label}: {case['kind'].numel()} groups, nreg {case['nreg']}, "
            f"cf {'given' if case['cf'] is not None else 'none'}: equal")
    return errs


def probe_comparator(name: str, args):
    """One PyTorch call computing a probe's function on its inputs: P1's
    torch.mm to float32; P2's index_select of the source's length-L windows
    (an unfold view) at the offsets, read from device memory by the call
    (0 <= off <= n - L, as at the probe's); P4's index_select of the rows
    off .. off + L, their index built here from the device offset, untimed,
    as take_windows builds K3's and K7's; P3's and P7's copy; P5's pad;
    P6's broadcasting add, its copies' index built untimed."""
    import torch

    x = args[0]
    if name == "dim0_dot":
        return lambda: torch.mm(x.T, args[1], out_dtype=torch.float32)
    if name == "1d_dma":
        windows, off = x.unfold(0, args[2], 1), args[1]
        return lambda: windows.index_select(0, off)
    if name == "3d_dma":
        rows = args[1][:1].to(torch.int64) + torch.arange(args[2], device=x.device)
        return lambda: x.index_select(1, rows)
    if name in ("flatten", "flatten_big"):
        return x.reshape(1, -1).clone
    if name == "lane_write":
        width, col = args[1], args[2]
        return lambda: torch.nn.functional.pad(x, (col, width - col - x.shape[1]))
    ar = torch.arange(args[1], dtype=x.dtype, device=x.device)[:, None]
    return lambda: torch.add(x[:, None, :], ar).view(x.shape[0], -1)


def p1_shapes(dev, card):
    """Phase 3f: P1 beyond the probe's shape, at tests/p1_cases.py's shapes
    (ragged tiles, several CTAs, K = 12288): one launch a call, equal to the
    twin on integer-valued inputs, within 2^-16 of the sum of |a_km b_kn|
    on random bf16 ones; and on bases that are not 16-byte aligned."""
    import torch

    from qb3_tpu_torch.ops.probe_cuda import dim0_dot, dim0_dot_plain
    from tests import p1_cases

    worst = 0.0
    for shape in p1_cases.SHAPES:
        for integer in (True, False):
            a, b = (torch.from_numpy(x).to(torch.bfloat16).to(dev)
                    for x in p1_cases.inputs(shape, integer))
            before = dim0_dot.launches
            got = dim0_dot(a, b)
            check(dim0_dot.launches == before + 1, f"P1 {shape}: not one launch")
            want = dim0_dot_plain(a, b)
            if integer:
                compare(f"P1 {shape}", got, want)
            else:
                tol = 2.0 ** -16 * (a.double().abs().T @ b.double().abs())
                ratio = float(((got.double() - want.double()).abs() / tol).max())
                check(ratio <= 1, f"P1 {shape} random: error {ratio:.3f} x the tolerance")
                worst = max(worst, ratio)
    a, b = (torch.from_numpy(x).to(torch.bfloat16).to(dev)
            for x in p1_cases.inputs((40, 64, 24), True))
    views = []
    for x in (a, b):
        flat = torch.zeros(x.numel() + 1, dtype=x.dtype, device=dev)
        flat[1:] = x.reshape(-1)
        views.append(flat[1:].view(x.shape))
    compare("P1 unaligned bases", dim0_dot(*views), dim0_dot_plain(a, b))
    log(f"P1 at {len(p1_cases.SHAPES)} shapes (K, M, N) {p1_cases.SHAPES} and on unaligned "
        f"bases: equal to its twin on integer-valued inputs, random bf16 within {worst:.4f} of "
        f"the tolerance 2^-16 sum |a b| ({card})")


def probe_phase(dev, card):
    """Phase 3f: P1-P7 at their probes' shapes against their twins and their
    probes' own checks, each beside one PyTorch call (probe_comparator),
    then P1 at more shapes (p1_shapes).  Returns per-kernel results."""
    import torch

    from qb3_tpu_torch import probes
    from qb3_tpu_torch.benchutil import median_ms

    results = {}
    for name in probes.PROBES:
        kern, plain = probes.KERNELS[name]
        args = probes.probe_inputs(name, dev)
        got = kern(*args)
        err = compare(name, got, plain(*args))
        check(probes.PROBES[name](dev), f"probe {name}: its check failed on the card")
        comp = probe_comparator(name, args)
        compare(name, comp(), got)
        kname = "flatten_kernel" if name.startswith("flatten") else f"{kern.__name__}_kernel"
        t = launch_times(lambda: kern(*args), kname)
        plain_ms = median_ms(lambda: plain(*args), 5)
        tc = launch_times(comp)
        tensors = [a for a in args if torch.is_tensor(a)]
        if name == "dim0_dot":
            need = (nbytes(*tensors, got), 2 * np.prod(args[0].shape) * args[1].shape[1],
                    BF16_FLOPS_PER_S)
        elif name in ("1d_dma", "3d_dma"):  # the words copied, the offset, the output
            need = (2 * nbytes(got) + nbytes(args[1]), 0)
        else:
            need = (nbytes(*tensors, got), got.numel() if name == "lane_concat" else 0)
        bms, by = bound(need)
        log(f"P {name} {kern.__name__} {tuple(got.shape)}: equal to its twin, probe check OK, "
            f"kernel {pack_times_text(t)}, twin {plain_ms:.4f} ms, "
            f"library {pack_times_text(tc)}, bound {bms:.6f} ms by {by} (floor {FLOOR_MS:.5f}) "
            f"({card})")
        results[f"probe_{name}"] = (err, t["ms"], plain_ms, need, tc["ms"], t["device_ms"],
                                    tc["busy_ms"])
    p1_shapes(dev, card)
    return results


def probe_main_path(kernels) -> dict:
    """The probes' main path, `python -m qb3_tpu_torch.probes` with all
    seven names: in this process with the launch counts set to 0 just
    before and read just after, then as its own process, which must print
    an OK line for each probe and exit 0.  Returns the launch counts."""
    from qb3_tpu_torch import probes

    names = list(probes.PROBES)
    reset(kernels)
    check(probes.main(names) == 0, "a probe failed")
    launches = {f"probe_{n}": probes.KERNELS[n][0].launches for n in names}
    log(f"launch counts on the probes' path: {launches}")
    check(all(v > 0 for v in launches.values()), "a probe's kernel was not launched")
    out = subprocess.run([sys.executable, "-m", "qb3_tpu_torch.probes", *names], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    ok = [line for line in out.stdout.splitlines() if line.endswith(": OK")]
    log(f"python -m qb3_tpu_torch.probes {' '.join(names)}: exit {out.returncode}, "
        f"{len(ok)} OK lines")
    check(out.returncode == 0 and len(ok) == len(names),
          f"the probes' module: {out.stdout[-2000:]} {out.stderr[-2000:]}")
    return launches


class no_twins:
    """Within the block, the twins of K1-K11 raise if called: the path
    inside runs on the kernels alone."""

    def __enter__(self):
        from qb3_tpu_torch.ops import (chunkwalk_cuda, encode_cuda, fusedwin_cuda, gather_cuda,
                                       pack_cuda, phase_a_cuda, place_cuda, quantize_cuda,
                                       wavefront_cuda)

        def refuse(*_, **__):
            raise AssertionError("a twin ran on the card's path")

        self.saved = [(m, n, getattr(m, n)) for m, n in (
            (wavefront_cuda, "wavefront8_plain"), (wavefront_cuda, "wavefront_wide_plain"),
            (gather_cuda, "gather_slabs_plain"), (pack_cuda, "pack_groups"),
            (pack_cuda, "extract_windows_plain"), (chunkwalk_cuda, "chunkwalk8_plain"),
            (fusedwin_cuda, "wavefront_fused_plain"), (encode_cuda, "encode_pack_image_plain"),
            (place_cuda, "place_slabs_plain"), (phase_a_cuda, "encode_fast_blocks"),
            (phase_a_cuda, "encode_best_blocks"), (quantize_cuda, "quantize_carrier_plain"))]
        for m, n, _ in self.saved:
            setattr(m, n, refuse)

    def __exit__(self, *exc):
        for m, n, fn in self.saved:
            setattr(m, n, fn)


def landsat_pin(dev, card, kernels) -> dict:
    """Phase 4b: the Landsat sample decodes on the card to LANDSAT_SHA256
    through the C++ walk, K7 and K5b, with the launch counts set to 0 just
    before and read just after and the twins refused.  Returns the counts."""
    import qb3_tpu_torch as qt
    from qb3_tpu_torch.benchutil import LANDSAT_SAMPLE, LANDSAT_SHA256

    with open(os.path.join(ROOT, LANDSAT_SAMPLE), "rb") as f:
        stream = f.read()
    reset(kernels)
    with no_twins():
        dec = qt.Decoder(stream, device=dev)
        out = dec.read_data()
    launches = {k: kernels[k].launches for k in ("gather_slabs", "wavefront8", "wavefront_wide")}
    sha = hashlib.sha256(out.tobytes()).hexdigest()
    check(sha == LANDSAT_SHA256, f"Landsat sample sha256 {sha} != {LANDSAT_SHA256}")
    check(dec.decode_path == "native-walk", f"Landsat sample: decode path {dec.decode_path}")
    check(launches == {"gather_slabs": 1, "wavefront8": 0, "wavefront_wide": 1},
          f"Landsat sample: launches {launches}")
    log(f"Landsat sample {out.shape} {out.dtype} (CF_H, no sidecar) sha256 {sha}: matches "
        f"qb3_tpu; {dec.decode_path}, launch counts {launches}, no twin on the path ({card})")
    return launches


def landsat_split(dev, card):
    """Phase 5: the Landsat sample's decode host to host, split as the walk
    decodes are (host walk, upload, K7, K5, reconstruct, the rest), and a
    device profile of it."""
    import torch

    import qb3_tpu_torch as qt
    from qb3_tpu_torch import api
    from qb3_tpu_torch.benchutil import (LANDSAT_SAMPLE, host_seconds,
                                         sustained)
    from qb3_tpu_torch.constants import HILBERT
    from qb3_tpu_torch.ops.decode import reconstruct
    from qb3_tpu_torch.ops.gather_cuda import gather_slabs
    from qb3_tpu_torch.ops.wavefront_cuda import wavefront_wide

    with open(os.path.join(ROOT, LANDSAT_SAMPLE), "rb") as f:
        stream = f.read()
    c = stream_walk(stream, dev)
    a, info = c["inp"], c["info"]
    h, w, nb = info.ysize, info.xsize, info.nbands
    words = api.padded_words(c["data"])

    def upload():
        api.walk_inputs(c["meta"], words, 16, dev)
        torch.cuda.synchronize()

    regs = gather_slabs(a["words32"], a["base"], a["nreg"], a["R"])
    k5 = (regs, a["off"], a["rung"], a["kind"], a["nreg"], 16, a["cf"])
    g = api.decode_groups(**a, tbits=16, apply_step=True)
    zero = torch.zeros(nb, dtype=torch.int64, device=dev)
    rec = (g.reshape(c["nblocks"], nb, 16), zero, h, w, nb, info.order or HILBERT,
           tuple(info.cband), 16)
    t = {"host walk": host_seconds(lambda: api.walk_offsets(c["data"], c["nblocks"], nb, 2,
                                                            info.mode)),
         "upload": host_seconds(upload),
         "K7": sustained(lambda: gather_slabs(a["words32"], a["base"], a["nreg"], a["R"]), 20),
         "K5": sustained(lambda: wavefront_wide(*k5), 20),
         "reconstruct": sustained(lambda: reconstruct(*rec), 20)}
    t_all = host_seconds(lambda: qt.decode(stream, device=dev))
    raw = h * w * nb * 2
    log(f"walk decode Landsat sample 512x512x8 u16 CF_H, host to host: "
        f"{raw / 1e6 / t_all:.2f} MB/s, {t_all * 1e3:.4f} ms; "
        + ", ".join(f"{k} {v * 1e3:.4f} ms" for k, v in t.items())
        + f"; the rest {(t_all - sum(t.values())) * 1e3:.4f} ms; kinds "
        f"{kind_counts(c['meta']['kind'])} ({card})")
    p = profiled(lambda: qt.decode(stream, device=dev))
    kms = {k: sum(v for op, v in p["per_op"].items() if k in op)
           for k in ("gather_slabs_kernel", "wavefront_wide_kernel")}
    log(f"profile walk decode Landsat sample: wall {p['wall_ms']:.4f} ms, device busy "
        f"{p['busy_ms']:.4f} ms (K7 {kms['gather_slabs_kernel']:.4f} ms, K5b "
        f"{kms['wavefront_wide_kernel']:.4f} ms), idle {p['idle']:.3f}, {p['ops']:.0f} device "
        f"ops, top {p['top'][:60]} {p['top_ms']:.4f} ms ({card})")


def strip_cases():
    """The strip shapes: label -> (raster, mode, sidecars to encode with).
    A u8 RGB scene as aerial or satellite orthophoto tiles are, 48 MiB, and
    a u16 elevation raster, 32 MiB."""
    from qb3_tpu_torch.benchutil import headline_image
    from qb3_tpu_torch.constants import Mode

    return {"u8 4096x4096x3 FTL": (headline_image(4096, 4096, 3, seed=300), Mode.FTL,
                                   (False, "ic")),
            "u16 4096x4096x1 BASE_H": (headline_image(4096, 4096, 1, seed=301, dtype=np.uint16),
                                       Mode.BASE_H, (True,))}


def row_pieces(h: int) -> list:
    """Uneven row pieces covering h rows, as a reader hands them over."""
    rng = np.random.default_rng(h)
    cuts = np.unique(np.concatenate([[0, h], rng.integers(1, h, max(2, h // 300))]))
    return list(zip(cuts[:-1], cuts[1:]))


def strip_encode(x, mode, index, dev, keep=None):
    """x through StripEncoder in uneven row pieces, STRIP_ROWS-row strips.
    keep, a dict, receives the strips' words and bit totals as finish()
    stitches them (every strip is encoded once the last row is pushed)."""
    import qb3_tpu_torch as qt
    from qb3_tpu_torch import api

    h, w, c = x.shape
    se = qt.StripEncoder(w, h, c, api.DT_FROM_NP[x.dtype], mode=mode, strip_rows=STRIP_ROWS,
                         with_index=index, device=dev)
    for a, b in row_pieces(h):
        se.push(x[a:b])
    if keep is not None:
        keep.update(parts=list(se._parts), totals=list(se._totals))
    return se.finish()


def strip_decode(stream, dev):
    """A stream through StripDecoder in STRIP_ROWS-row reads -> (raster,
    the decode path of its last strip)."""
    import qb3_tpu_torch as qt

    sd = qt.StripDecoder(stream, strip_rows=STRIP_ROWS, device=dev)
    rows = []
    while (r := sd.read(STRIP_ROWS)) is not None:
        rows.append(r)
    return np.concatenate(rows), sd.decode_path


def k6_inputs(dev, x, mode) -> tuple:
    """K6's inputs at the stitch of the strip encode of x in mode: (the
    strips' words, their bit totals, the stitch's slabs and bases as the
    CPU route cuts them, words in the stream)."""
    from qb3_tpu_torch.stitch import stitch_slabs

    keep = {}
    strip_encode(x, mode, False, dev, keep)
    slab, base = stitch_slabs(keep["parts"], keep["totals"])
    return keep["parts"], keep["totals"], slab, base, -(-sum(keep["totals"]) // 32)


def k6_calls(slab, base, n_out) -> tuple:
    """K6's slab entry on its inputs (zero fill + atomic adds), and its
    yardstick: index_add_ of the slabs into a zeroed stream, the index
    built untimed -> (slab entry call, index_add_ call)."""
    import torch

    from qb3_tpu_torch.ops.place_cuda import place_slabs

    idx = base.to(torch.int64)[:, None] + torch.arange(slab.shape[1], device=slab.device)
    live = idx < n_out
    idx, vals = torch.where(live, idx, 0).reshape(-1), torch.where(live, slab, 0).reshape(-1)

    def index_add():
        return torch.zeros(n_out, dtype=torch.int32, device=slab.device).index_add_(0, idx, vals)

    return (lambda: place_slabs(slab, base, n_out)), index_add


def cold_l2_times(fn, op: str, names) -> dict:
    """One call's device times with the L2 cache flushed before each call:
    a reduction reads 128 MiB (the H100's L2 holds 50 MB) and leaves only
    clean lines.  From a profile of 20 calls -> device_ms (the operations
    whose name holds op), busy_ms (the operations named in names, those the
    call issues warm) and flush_ms (every other operation: the flush)."""
    import torch

    flush = torch.ones(32 << 20, dtype=torch.int32, device="cuda")
    p = profiled(lambda: (flush.sum(), fn()), 20)
    mine = {k: v for k, v in p["per_op"].items() if k in names}
    return dict(device_ms=sum(v for k, v in mine.items() if op in k), busy_ms=sum(mine.values()),
                flush_ms=p["busy_ms"] - sum(mine.values()))


def cold_text(t: dict) -> str:
    return (f"L2 flushed before each call: device {t['busy_ms']:.4f} ms (kernel "
            f"{t['device_ms']:.4f} ms; the flush {t['flush_ms']:.4f} ms)")


def k6_phase(dev, card, cases: dict):
    """Phase 3e: both entries of K6 at the stitch of each strip encode
    (cases: label -> (raster, mode); the first is the u8 4096x4096x3 FTL
    scene, whose times the kernels line keeps).  The slab entry
    (place_slabs: zero fill + atomics) at the slabs the CPU route cuts,
    against its twin and index_add_ (the yardstick); the stitch entry
    (stitch_words_device, one launch over the parts where they lie) against
    its twin (the CPU route on the card: stitch_slabs, then
    place_slabs_plain) and the host stitch_bytes.  Each call's device ms
    and device ops from a profile, K6's rows judged by all that a call
    issues; and both entries' device ms again with the L2 cache flushed
    before each call (cold_l2_times), since the inputs (35-55 MB) fit or
    nearly fit in the L2 and repeated calls read them warm."""
    import torch

    from qb3_tpu_torch.benchutil import median_ms
    from qb3_tpu_torch.ops.bitpack import words_to_bytes
    from qb3_tpu_torch.ops.place_cuda import place_slabs_plain
    from qb3_tpu_torch.stitch import stitch_bytes, stitch_slabs, stitch_words_device

    res = {}
    for label, (x, mode) in cases.items():
        parts, totals, slab, base, n_out = k6_inputs(dev, x, mode)
        place, index_add = k6_calls(slab, base, n_out)
        got = place()
        err = compare("place_slabs", got, place_slabs_plain(slab, base, n_out))
        compare("place_slabs", index_add(), got)
        t = launch_times(place, "place_slabs_kernel")
        cold = cold_l2_times(place, "place_slabs_kernel", t["names"])
        plain = median_ms(lambda: place_slabs_plain(slab, base, n_out), 5)
        tl = launch_times(index_add)
        need = (nbytes(slab, base, got), slab.numel())
        bms, by = bound(need)
        log(f"K6 place_slabs (slab entry) {label} strip stitch: {slab.shape[0]} slabs "
            f"{tuple(slab.shape)}, {n_out} words: equal, {pack_times_text(t)}; "
            f"{cold_text(cold)}; twin {plain:.4f} ms, index_add_ "
            f"{pack_times_text(tl)}, bound {bms:.5f} ms by {by} ({need[0]} bytes, {need[1]} "
            f"adds) ({card})")
        entry = (err, t["ms"], plain, need, tl["ms"], t["busy_ms"], tl["busy_ms"])
        res["place_slabs"] = ((max(err, res["place_slabs"][0]),) + res["place_slabs"][1:]
                              if "place_slabs" in res else entry)

        stitch = lambda: stitch_words_device(parts, totals, n_out)[0]  # noqa: E731
        twin = lambda: place_slabs_plain(*stitch_slabs(parts, totals), n_out)  # noqa: E731
        got = stitch()
        err = compare("place_slabs stitch", got, twin())
        total = sum(totals)
        check(words_to_bytes(got.cpu().numpy().view(np.uint32), total)
              == stitch_bytes([(p.cpu().numpy(), n) for p, n in zip(parts, totals)]),
              f"K6 stitch entry {label}: the bytes differ from the host stitch_bytes")
        t = launch_times(stitch, "place_parts_kernel")
        extra = [n for n in t["names"] if "place_parts_kernel" not in n and "Memcpy HtoD" not in n]
        check(t["ops"] <= 2 and not extra and any("place_parts_kernel" in n for n in t["names"]),
              f"K6 stitch entry {label}: {t['ops']:g} device ops a call ({t['names']}), want "
              "the kernel and at most the table's copy")
        cold = cold_l2_times(stitch, "place_parts_kernel", t["names"])
        plain = median_ms(twin, 5)
        src_words = sum(-(-int(n) // 32) for n in totals)
        need = (4 * (src_words + n_out) + 48 * sum(int(n) > 0 for n in totals),
                PLACE_OPS * src_words)
        bms, by = bound(need)
        log(f"K6 place_slabs (stitch entry) {label} strip stitch: {len(parts)} parts, "
            f"{total} bits, {n_out} words: equal to the twin and stitch_bytes, "
            f"{pack_times_text(t)}; {cold_text(cold)}; twin "
            f"(stitch_slabs + place_slabs_plain) {plain:.4f} ms, bound {bms:.5f} ms by {by} "
            f"({need[0]} bytes, {need[1]} operations) ({card})")
        entry = (err, t["ms"], plain, need, None, t["busy_ms"], None)
        res["place_slabs stitch"] = (
            (max(err, res["place_slabs stitch"][0]),) + res["place_slabs stitch"][1:]
            if "place_slabs stitch" in res else entry)
        del parts, slab, base, got
        torch.cuda.empty_cache()
    return res


def slab_route(words, totals, n_out):
    """The parent's device stitch: the slab cut in plain PyTorch
    (stitch_slabs), then K6's any-order entry (zero fill + atomic adds)."""
    from qb3_tpu_torch.ops.place_cuda import place_slabs
    from qb3_tpu_torch.stitch import stitch_slabs

    return place_slabs(*stitch_slabs(words, totals), n_out)


class slab_stitch:
    """Within the block (on: True), StripEncoder.finish and the sharded
    encodes stitch by the slab route, the parent's device stitch, for an
    A/B in one process."""

    def __init__(self, on: bool):
        self.on = on

    def __enter__(self):
        from qb3_tpu_torch import strip
        from qb3_tpu_torch.parallel import sharded

        self.saved = [(m, m.stitch_words_device) for m in (strip, sharded)]
        if self.on:
            for m, _ in self.saved:
                m.stitch_words_device = lambda words, totals, n_out: (
                    slab_route(words, totals, n_out), sum(int(t) for t in totals))

    def __exit__(self, *exc):
        for m, fn in self.saved:
            m.stitch_words_device = fn


def strip_phase(dev, card, kernels, cases):
    """Phase 5, the streaming strips: each strip encode against the
    whole-image encode on the card, each stream decoded by StripDecoder,
    the launch counts set to 0 just before each strip encode and decode
    and read just after; then host-to-host MB/s of the strip and whole-image
    encodes and decodes, K6's stitch beside the host stitch and the slab
    route it replaced, the strip encode with each stitch in turns, and the
    peak device memory of both encodes.  Returns the launch counts summed
    over the strip paths."""
    import qb3_tpu_torch as qt
    from qb3_tpu_torch.benchutil import host_seconds, sustained
    from qb3_tpu_torch.ops.bitpack import words_to_bytes
    from qb3_tpu_torch.stitch import stitch_bytes, stitch_words_device

    enc_path = ("place_slabs", "place_parts", "phase_a_fast", "pack_groups_chunked",
                "encode_pack_image")
    dec_path = ("gather_slabs", "wavefront8", "wavefront_wide")
    launches = dict.fromkeys(enc_path + dec_path, 0)
    streams = {}
    for label, (x, mode, indexes) in cases.items():
        nstrips = -(-x.shape[0] // STRIP_ROWS)
        wide = x.itemsize > 1
        for index in indexes:
            name = f"{label} {index or 'no sidecar'}"
            reset(kernels)
            keep = {}
            s = strip_encode(x, mode, index, dev, keep)
            enc = {k: kernels[k].launches for k in enc_path}
            nparts = len(keep.pop("parts"))  # the last push encodes all rows left as one strip
            reset(kernels)
            out, path = strip_decode(s, dev)
            dec = {k: kernels[k].launches for k in dec_path}
            log(f"launch counts of the strips {name}: encode {enc}, decode {dec}")
            check(enc == {"place_slabs": 0, "place_parts": 1,
                          "phase_a_fast": 0 if wide else nparts,
                          "pack_groups_chunked": 0 if wide else nparts,
                          "encode_pack_image": nparts if wide else 0},
                  f"strips {name}: the encode's launches")
            check(dec == {"gather_slabs": nstrips, "wavefront8": 0 if wide else nstrips,
                          "wavefront_wide": nstrips if wide else 0},
                  f"strips {name}: the decode's launches")
            for k in launches:
                launches[k] += enc.get(k, 0) + dec.get(k, 0)
            check(np.array_equal(out, x), f"strips {name}: decode differs")
            check(path == "native-walk", f"strips {name}: decode path {path}")
            check(s == qt.encode(x, mode=mode, index=index, device=dev),
                  f"strips {name}: stream differs from the whole-image encode")
            streams[name] = s
            log(f"strips {name}: {len(s)} bytes (ratio {len(s) / x.nbytes:.4f}), equal to the "
                f"whole-image encode on the card, decoded losslessly in {STRIP_ROWS}-row reads "
                f"({path}; {card})")

    for label, (x, mode, indexes) in cases.items():
        mb = x.nbytes / 1e6
        for index in indexes:
            name = f"{label} {index or 'no sidecar'}"
            s = streams[name]
            d = qt.Decoder(s, device=dev)
            d.read_data()
            t = {"strip encode": host_seconds(lambda: strip_encode(x, mode, index, dev), 2),
                 "whole encode": host_seconds(
                     lambda: qt.encode(x, mode=mode, index=index, device=dev), 2),
                 "strip decode": host_seconds(lambda: strip_decode(s, dev), 2),
                 f"whole decode ({d.decode_path})": host_seconds(
                     lambda: qt.decode(s, device=dev), 2)}
            log(f"host to host {name}: " + ", ".join(
                f"{k} {mb / v:.2f} MB/s ({v * 1e3:.1f} ms)" for k, v in t.items()) + f" ({card})")
        # K6's stitch against the host stitch it replaces and the slab route
        # (the parent's device stitch), on the same strips
        index = indexes[0]
        keep = {}
        strip_encode(x, mode, index, dev, keep)
        parts, totals = keep["parts"], keep["totals"]
        total = sum(totals)
        n_out = -(-total // 32)

        def device_stitch():
            words, _ = stitch_words_device(parts, totals, n_out)
            return words_to_bytes(words.cpu().numpy().view(np.uint32), total)

        def host_stitch():
            return stitch_bytes([(p.cpu().numpy(), t) for p, t in zip(parts, totals)])

        check(device_stitch() == host_stitch(), f"strips {label}: the stitches differ")
        t_dev, t_host = host_seconds(device_stitch, 5), host_seconds(host_stitch, 5)
        t_res = sustained(lambda: stitch_words_device(parts, totals, n_out), 10)
        t_slab = sustained(lambda: slab_route(parts, totals, n_out), 10)
        log(f"stitch {label}, {len(parts)} strips, {total} bits: K6 stitch to host bytes "
            f"{t_dev * 1e3:.4f} ms (device-resident {t_res * 1e3:.4f} ms; the slab route, "
            f"stitch_slabs + zero fill + atomic K6, {t_slab * 1e3:.4f} ms), host stitch "
            f"(download every strip, stitch_bytes) {t_host * 1e3:.4f} ms ({card})")
        for name, fn in (("device-resident stitch", lambda: stitch_words_device(parts, totals,
                                                                                 n_out)),
                         ("slab route", lambda: slab_route(parts, totals, n_out))):
            p = profiled(fn)
            log(f"profile {name} {label}: wall {p['wall_ms']:.4f} ms, device busy "
                f"{p['busy_ms']:.4f} ms, idle {p['idle']:.3f}, {p['ops']:.0f} device ops, top "
                f"{p['top'][:60]} {p['top_ms']:.4f} ms ({card})")
            if name == "device-resident stitch":
                check(p["ops"] <= 3, f"strips {label}: the device stitch issues {p['ops']:.0f} "
                                     "device ops")
        del keep, parts
        # the strip encode with the stitch entry and with the slab route, in
        # turns; peak device memory above what is allocated before the call
        runs = {"stitch entry": [], "slab route": []}
        peaks = {}
        for name in ("slab route", "stitch entry", "stitch entry", "slab route"):
            with slab_stitch(name == "slab route"):
                runs[name].append(host_seconds(lambda: strip_encode(x, mode, index, dev), 2))
                peaks[name] = peak_bytes(lambda: strip_encode(x, mode, index, dev))
        peaks["whole encode"] = peak_bytes(lambda: qt.encode(x, mode=mode, index=index,
                                                             device=dev))
        log(f"strip encode {label} {index or 'no sidecar'} in turns: stitch entry "
            + ", ".join(f"{mb / v:.2f} MB/s ({v * 1e3:.1f} ms)" for v in runs["stitch entry"])
            + "; slab route "
            + ", ".join(f"{mb / v:.2f} MB/s ({v * 1e3:.1f} ms)" for v in runs["slab route"])
            + f" ({card})")
        log(f"peak device memory {label}: strip encode {peaks['stitch entry'] / 2**20:.1f} MiB "
            f"(with the slab route {peaks['slab route'] / 2**20:.1f} MiB), whole encode "
            f"{peaks['whole encode'] / 2**20:.1f} MiB "
            f"({peaks['whole encode'] / peaks['stitch entry']:.2f}x) ({card})")
    return launches


def fixture_phase(dev):
    """Phase 4a: every web fixture decoded to its raw bytes and re-encoded by
    the port to its bytes, the three best-mode ones included."""
    from qb3_tpu_torch import api, container
    from qb3_tpu_torch.constants import Mode, is_best_mode

    with open(os.path.join(ROOT, "web", "test", "fixtures.js")) as f:
        text = f.read()
    cases = json.loads(text[text.index("["): text.rindex("]") + 1])
    check(len(cases) >= 20, f"only {len(cases)} web fixtures")
    matched = decoded = best = 0
    for c in cases:
        stream = base64.b64decode(c["stream"])
        info = container.parse_headers(stream)
        raw = np.frombuffer(base64.b64decode(c["raw"]), np.dtype(c["dtype"]))
        raw = raw.reshape(c["shape"])
        dec = api.Decoder(stream, device=dev)
        check(dec.read_data().tobytes() == raw.tobytes(), f"fixture {c['name']}: decode differs")
        decoded += 1
        log(f"fixture {c['name']}: port decode ({dec.decode_path}) equals raw")
        mode = Mode.FTL if info.mode == Mode.STORED else info.mode
        got = api.encode(raw, mode=mode, quanta=info.quanta, coreband=info.cband,
                         index="ic" if info.index_chunked else False, device=dev)
        if got != stream:
            check(info.quanta > 1, f"fixture {c['name']}: port bytes differ")
            log(f"fixture {c['name']}: left out, its dequantized raw does not "
                "re-quantize to the stream's values")
            continue
        matched += 1
        best += is_best_mode(info.mode)
    log(f"fixtures: {matched} of {len(cases)} streams re-encoded byte-exact ({best} of them "
        f"best mode), {decoded} decoded to their raw bytes")
    check(decoded == len(cases) == 20, f"{decoded} of {len(cases)} fixtures decoded")
    check(best == 3, f"{best} of the 3 best-mode fixtures re-encoded to their bytes")


def best_pins(dev, img):
    """Phase 4c: the best headline (u8 512x512x3 CF_H) with "ib" and with
    "ic" to BEST_HEADLINE_SHA256, and the Landsat sample decoded and encoded
    again (CF_H, its core bands) to LANDSAT_ENCODE_SHA256, its own bytes."""
    import qb3_tpu_torch as qt
    from qb3_tpu_torch import container
    from qb3_tpu_torch.benchutil import (BEST_HEADLINE_SHA256, LANDSAT_ENCODE_SHA256,
                                         LANDSAT_SAMPLE)
    from qb3_tpu_torch.constants import Mode

    for index, sig in ((True, "ib"), ("ic", "ic")):
        sha = hashlib.sha256(qt.encode(img, mode=Mode.CF_H, index=index, device=dev)).hexdigest()
        check(sha == BEST_HEADLINE_SHA256[sig],
              f"best headline {sig} sha256 {sha} != {BEST_HEADLINE_SHA256[sig]}")
    log("best headline 512x512x3 u8 CF_H ib and ic streams: sha256s match qb3_tpu")
    with open(os.path.join(ROOT, LANDSAT_SAMPLE), "rb") as f:
        sample = f.read()
    info = container.parse_headers(sample)
    again = qt.encode(qt.decode(sample, device=dev)[0], mode=info.mode, coreband=info.cband,
                      device=dev)
    sha = hashlib.sha256(again).hexdigest()
    check(sha == LANDSAT_ENCODE_SHA256 and again == sample,
          f"Landsat sample encoded again: sha256 {sha} != {LANDSAT_ENCODE_SHA256}")
    log(f"Landsat sample 512x512x8 u16 encoded again in CF_H: sha256 {sha}, its own bytes, "
        "matches qb3_tpu")


def best_round_trips(dev, kernels, label, x) -> dict:
    """x in CF_H with "ib", "ic" and no sidecar through the public encode and
    decode, the launch counts set to 0 just before and read just after; each
    decode takes the path its stream's sidecar names.  Returns the counts."""
    import qb3_tpu_torch as qt
    from qb3_tpu_torch import container
    from qb3_tpu_torch.constants import Mode

    k5 = "wavefront8" if x.itemsize == 1 else "wavefront_wide"
    reset(kernels)
    paths = []
    for index in (True, "ic", False):
        s = qt.encode(x, mode=Mode.CF_H, index=index, device=dev)
        info = container.parse_headers(s)
        d = qt.Decoder(s, device=dev)
        check(np.array_equal(d.read_data(), x), f"best {label} {index}: round trip")
        want = ("ib" if info.index_best else "ic-best" if info.index_chunked
                else "native-walk")
        check(info.mode == Mode.CF_H and d.decode_path == want,
              f"best {label} {index}: mode {info.mode}, decode path {d.decode_path}")
        paths.append(f"{index or 'no sidecar'}: {d.decode_path}, ratio {len(s) / x.nbytes:.4f}")
    counts = {k: kernels[k].launches
              for k in ("phase_a_best", "pack_groups_chunked", "gather_slabs", k5)}
    log(f"lossless best {label} CF_H ({'; '.join(paths)}); launch counts {counts}")
    check(counts["pack_groups_chunked"] == counts["phase_a_best"] == 3 and all(counts.values()),
          f"best {label}: a kernel of the path was not launched ({counts})")
    return counts


def best_phase(dev, card, kernels, imgs: dict, tiles, elevation) -> dict:
    """Phase 5, the best modes: CF_H round trips with "ib", "ic" and no
    sidecar of u8 512x512x3 and u64 1024x1024x1 rasters, a CF_H batch of
    BATCH u8 512x512x3 tiles with "ib" sidecars, and the u16 4096x4096x1
    elevation raster through StripEncoder / StripDecoder, each with its
    launch counts set to 0 just before and read just after; device-resident
    and host-to-host MB/s, the encode split into phase A and K1 and the
    "ic"-best decode into its walk (plain PyTorch on the card) and
    reconstruct, the batch's and the strips' peak device memory.  Returns
    the launch counts by BEST_K1 entry and by kernel."""
    import torch

    import qb3_tpu_torch as qt
    from qb3_tpu_torch import api, container
    from qb3_tpu_torch.benchutil import host_seconds, sustained
    from qb3_tpu_torch.constants import HILBERT, Mode
    from qb3_tpu_torch.ops import bitpack
    from qb3_tpu_torch.ops.decode import reconstruct
    from qb3_tpu_torch import batch
    from qb3_tpu_torch.ops.decode_chunked import decode_chunked_best, parse_ic_best
    from qb3_tpu_torch.ops.pack_cuda import pack_groups_chunked
    from qb3_tpu_torch.ops.phase_a_cuda import phase_a_best

    counts = {label: best_round_trips(dev, kernels, label, x) for label, x in imgs.items()}
    for label, x in imgs.items():
        (h, w, nb), tb = x.shape, 8 * x.itemsize
        mb = x.nbytes / 1e6
        cband = tuple(api.default_cband(nb))
        n_words = api.stream_words(w, h, nb, api.DT_FROM_NP[x.dtype])
        zero = torch.zeros(nb, dtype=torch.int64, device=dev)
        xd = api.to_carrier(x, dev)
        enc = (xd, zero, zero, zero, HILBERT, cband, tb)
        codes, lens = phase_a_best(*enc)[:2]
        bound = bitpack.group_bits_bound(tb, best=True)
        t_enc = sustained(lambda: api.best_encode(*enc, n_words), 10)
        t_pa = sustained(lambda: phase_a_best(*enc), 10)
        t_k1 = sustained(lambda: pack_groups_chunked(codes, lens, n_words, bound), 20)
        log(f"device encode best {label} CF_H: {mb / t_enc:.2f} MB/s ({t_enc * 1e3:.4f} ms) = "
            f"phase A {t_pa * 1e3:.4f} ms + K1 {t_k1 * 1e3:.4f} ms ({card})")
        p = profiled(lambda: api.best_encode(*enc, n_words), 3)
        log(f"profile best encode {label}: wall {p['wall_ms']:.4f} ms, device busy "
            f"{p['busy_ms']:.4f} ms, idle {p['idle']:.3f}, {p['ops']:.0f} device ops, top "
            f"{p['top'][:60]} {p['top_ms']:.4f} ms ({card})")
        del codes, lens
        s = qt.encode(x, mode=Mode.CF_H, index="ic", device=dev)
        info = container.parse_headers(s)
        data = s[info.data_offset:]
        nblocks = (h // 4) * (w // 4)
        meta = parse_ic_best(info.index_chunked, nblocks, nb) if info.index_chunked else None
        if meta is not None:
            inp = api.ic_best_inputs(api.padded_words(data), meta, dev)
            args = (inp["words32"], inp["starts"], inp["entry"], inp["pcf"], inp["k"],
                    nblocks, nb, tb)
            g = decode_chunked_best(*args)
            rec = (g.reshape(nblocks, nb, 16), zero, h, w, nb, HILBERT, cband, tb)
            check(np.array_equal(api.from_carrier(reconstruct(*rec)[0], x.itemsize), x),
                  f"best {label}: device ic-best decode")
            t_walk = sustained(lambda: decode_chunked_best(*args), 3)
            t_rec = sustained(lambda: reconstruct(*rec), 20)
            log(f"device decode ic-best {label}: {mb / (t_walk + t_rec):.2f} MB/s = the walk "
                f"{t_walk * 1e3:.4f} ms ({meta[1].size} chunks, {meta[0]} blocks x {nb} bands "
                f"a chunk, one step of PyTorch ops a group) + reconstruct {t_rec * 1e3:.4f} ms "
                f"({card})")
            del inp, args, g, rec
        rates = {}
        for index in (True, "ic", False):
            st = qt.encode(x, mode=Mode.CF_H, index=index, device=dev)
            name = f"{index or 'no sidecar'}"
            rates[f"encode {name}"] = mb / host_seconds(
                lambda index=index: qt.encode(x, mode=Mode.CF_H, index=index, device=dev), 3)
            d = qt.Decoder(st, device=dev)
            d.read_data()
            rates[f"decode {name} ({d.decode_path})"] = mb / host_seconds(
                lambda st=st: qt.decode(st, device=dev), 3)
        log(f"host to host best {label} CF_H: " + ", ".join(
            f"{k} {v:.2f} MB/s" for k, v in rates.items()) + f" ({card})")
        del xd, enc

    # the batch: encode_tiles / decode_tiles, launch counts, peak memory
    reset(kernels)
    peak = {"encode": peak_bytes(lambda: qt.encode_tiles(tiles, mode=Mode.CF_H, index=True,
                                                         device=dev))}
    enc_counts = {k: kernels[k].launches for k in ("pack_groups_chunked", "phase_a_best")}
    passes = -(-len(tiles) // max(1, batch.BEST_GROUPS // (128 * 128 * 3)))
    streams = qt.encode_tiles(tiles, mode=Mode.CF_H, index=True, device=dev)
    reset(kernels)
    out = {}
    peak["decode"] = peak_bytes(lambda: out.update(t=qt.decode_tiles(streams, device=dev)))
    dec_counts = {k: kernels[k].launches for k in ("gather_slabs", "wavefront8")}
    log(f"launch counts of the best batch{BATCH}: encode {enc_counts}, decode {dec_counts}")
    check(enc_counts == {"pack_groups_chunked": 1, "phase_a_best": passes}
          and dec_counts == {"gather_slabs": 1, "wavefront8": 1},
          "best batch: the launches of the encode and the decode")
    check(np.array_equal(out["t"], tiles), "best batch round trip")
    check(streams[0] == qt.encode(tiles[0], mode=Mode.CF_H, index=True, device=dev)
          and container.parse_headers(streams[0]).index_best is not None,
          "best batch: a tile's stream differs from its single encode")
    mb = tiles.nbytes / 1e6
    t_e = host_seconds(lambda: qt.encode_tiles(tiles, mode=Mode.CF_H, index=True, device=dev), 2)
    t_d = host_seconds(lambda: qt.decode_tiles(streams, device=dev), 2)
    log(f"best batch{BATCH} u8 512x512x3 CF_H ib, host to host: encode {mb / t_e:.2f} MB/s "
        f"({t_e * 1e3:.1f} ms), decode {mb / t_d:.2f} MB/s ({t_d * 1e3:.1f} ms); peak device "
        f"memory encode {peak['encode'] / 2**30:.2f} GiB, decode "
        f"{peak['decode'] / 2**30:.2f} GiB; ratio {sum(map(len, streams)) / tiles.nbytes:.4f} "
        f"({card})")
    del streams, out

    # the strips: the u16 elevation raster in STRIP_ROWS-row strips
    x = elevation
    nstrips = -(-x.shape[0] // STRIP_ROWS)
    reset(kernels)
    keep = {}
    s = strip_encode(x, Mode.CF_H, True, dev, keep)
    nparts = len(keep.pop("parts"))
    enc = {k: kernels[k].launches for k in ("place_slabs", "place_parts", "pack_groups_chunked",
                                            "encode_pack_image", "phase_a_best")}
    reset(kernels)
    rows, path = strip_decode(s, dev)
    dec = {k: kernels[k].launches for k in ("gather_slabs", "wavefront8", "wavefront_wide")}
    log(f"launch counts of the best strips u16 4096x4096x1 CF_H ib: encode {enc}, decode {dec}")
    check(enc == {"place_slabs": 0, "place_parts": 1, "pack_groups_chunked": nparts,
                  "encode_pack_image": 0, "phase_a_best": nparts},
          "best strips: the encode's launches")
    check(dec == {"gather_slabs": nstrips, "wavefront8": 0, "wavefront_wide": nstrips},
          "best strips: the decode's launches")
    check(np.array_equal(rows, x) and path == "native-walk", f"best strips: decode ({path})")
    whole = qt.encode(x, mode=Mode.CF_H, index=True, device=dev)
    check(s == whole, "best strips: stream differs from the whole-image encode")
    mb = x.nbytes / 1e6
    t = {"strip encode": host_seconds(lambda: strip_encode(x, Mode.CF_H, True, dev), 2),
         "whole encode": host_seconds(
             lambda: qt.encode(x, mode=Mode.CF_H, index=True, device=dev), 2),
         "strip decode": host_seconds(lambda: strip_decode(s, dev), 2),
         "whole decode (ib)": host_seconds(lambda: qt.decode(s, device=dev), 2)}
    peaks = {"strip": peak_bytes(lambda: strip_encode(x, Mode.CF_H, True, dev)),
             "whole": peak_bytes(lambda: qt.encode(x, mode=Mode.CF_H, index=True,
                                                   device=dev))}
    log(f"best strips u16 4096x4096x1 CF_H ib: {len(s)} bytes (ratio {len(s) / x.nbytes:.4f}), "
        f"equal to the whole-image encode, decoded losslessly in {STRIP_ROWS}-row reads; host "
        f"to host " + ", ".join(f"{k} {mb / v:.2f} MB/s ({v * 1e3:.1f} ms)" for k, v in t.items())
        + f"; peak device memory strip encode {peaks['strip'] / 2**20:.1f} MiB, whole encode "
        f"{peaks['whole'] / 2**20:.1f} MiB ({card})")
    k1 = {name: counts[label]["pack_groups_chunked"] for name, label in BEST_K1.items()}
    k1["pack_groups_chunked best S=27"] += enc_counts["pack_groups_chunked"] + nparts
    launches = {k: sum(c.get(k, 0) for c in counts.values()) + dec_counts.get(k, 0)
                + dec.get(k, 0) for k in ("gather_slabs", "wavefront8", "wavefront_wide")}
    launches["place_slabs"] = enc["place_slabs"]
    launches["place_parts"] = enc["place_parts"]
    launches["phase_a_best"] = (sum(c["phase_a_best"] for c in counts.values())
                                + enc_counts["phase_a_best"] + enc["phase_a_best"])
    return k1, launches


def walk_phase(dev, card, img, wide_imgs, kernels, ic_stream, ix_stream):
    """Phase 5, the decode without a sidecar: the default encode's streams
    through the public decode (the C++ walk on the host, then K7 and K5 on
    the card) with the launch counts set to 0 just before and read just
    after; then each stream's decode split into its stages, host-to-host
    MB/s beside the "ic" and "ix" decodes of the same image, and a device
    profile.  Returns the walk path's launch counts."""
    import torch

    import qb3_tpu_torch as qt
    from qb3_tpu_torch import api, container
    from qb3_tpu_torch.benchutil import host_seconds, sustained
    from qb3_tpu_torch.constants import HILBERT, Mode
    from qb3_tpu_torch.ops.decode import decode_groups, reconstruct
    from qb3_tpu_torch.ops.gather_cuda import gather_slabs
    from qb3_tpu_torch.ops.wavefront_cuda import wavefront8, wavefront_wide

    nodata = img.copy()
    nodata[64:320, 96:448] = 0  # a no-data area: zero runs the RLE0 pass takes
    walk_cases = {"u8 512x512x3 FTL": (img, Mode.FTL), "u8 512x512x3 BASE_Z": (img, Mode.BASE_Z),
                  "u8 512x512x3 no-data RLE_H": (nodata, Mode.RLE_H),
                  **{label: (x, Mode.FTL) for label, x in wide_imgs.items()}}
    walk_path = ("gather_slabs", "wavefront8", "wavefront_wide")
    reset(kernels)
    walk_streams = {}
    for label, (x, mode) in walk_cases.items():
        s = qt.encode(x, mode=mode, device=dev)
        check(container.parse_headers(s).mode == mode, f"walk {label}: stream mode")
        d = qt.Decoder(s, device=dev)
        check(np.array_equal(d.read_data(), x), f"walk {label} round trip")
        check(d.decode_path == "native-walk", f"walk {label}: decode path {d.decode_path}")
        walk_streams[label] = s
        log(f"lossless walk: {label} (ratio {len(s) / x.nbytes:.4f}, {d.decode_path})")
    walk_launches = {name: kernels[name].launches for name in walk_path}
    log(f"launch counts on the walk path: {walk_launches}")
    check(all(n > 0 for n in walk_launches.values()), "a kernel of the walk path was not launched")

    for label, (x, mode) in walk_cases.items():
        # the walk decode, host to host, split into its stages: the C++ walk
        # and the upload on the host clock, K7, K5 and reconstruct on the card
        c = stream_walk(qt.encode(x, mode=mode, device=dev), dev)
        check(c["stream"] == walk_streams[label], f"walk {label}: stream differs")
        a, tb, (h, w, nb) = c["inp"], 8 * x.itemsize, x.shape
        info = c["info"]
        kw = dict(tbits=tb, apply_step=info.mode != Mode.FTL)
        words = api.padded_words(c["data"])

        def upload(c=c, words=words, tb=tb):
            api.walk_inputs(c["meta"], words, tb, dev)
            torch.cuda.synchronize()

        regs = gather_slabs(a["words32"], a["base"], a["nreg"], a["R"])
        k5 = (regs, a["off"], a["rung"], a["kind"], a["nreg"])
        g = decode_groups(**a, **kw)
        zero = torch.zeros(nb, dtype=torch.int64, device=dev)
        rec = (g.reshape(c["nblocks"], nb, 16), zero, h, w, nb, info.order or HILBERT,
               tuple(info.cband), tb)
        t = {"host walk": host_seconds(lambda c=c, x=x: api.walk_offsets(
                 c["data"], c["nblocks"], x.shape[2], x.itemsize, c["info"].mode)),
             "upload": host_seconds(upload),
             "K7": sustained(lambda a=a: gather_slabs(a["words32"], a["base"], a["nreg"],
                                                      a["R"]), 20),
             "K5": sustained(lambda k5=k5, tb=tb: wavefront8(*k5) if tb == 8
                             else wavefront_wide(*k5, tb), 20),
             "reconstruct": sustained(lambda rec=rec: reconstruct(*rec), 20)}
        t_all = host_seconds(lambda s=c["stream"]: qt.decode(s, device=dev))
        log(f"walk decode {label}, host to host: {x.nbytes / 1e6 / t_all:.2f} MB/s, "
            f"{t_all * 1e3:.4f} ms; " + ", ".join(f"{k} {v * 1e3:.4f} ms" for k, v in t.items())
            + f"; the rest {(t_all - sum(t.values())) * 1e3:.4f} ms ({card})")
        del a, regs, k5, g, rec

    # host to host, one u8 512x512x3 tile, the same image without a sidecar,
    # with "ic" and with "ix", in turns
    same = {"walk": walk_streams["u8 512x512x3 FTL"], "ic": ic_stream, "ix": ix_stream}
    h2h = {k: [] for k in same}
    for k in ("walk", "ic", "ix", "ix", "ic", "walk"):
        h2h[k].append(host_seconds(lambda k=k: qt.decode(same[k], device=dev)))
    log("host-to-host decode u8 512x512x3, in turns: " + ", ".join(
        f"{k} {img.nbytes / 1e6 * 2 / sum(v):.2f} MB/s" for k, v in h2h.items()) + f" ({card})")
    p = profiled(lambda: qt.decode(same["walk"], device=dev))
    kms = {k: sum(v for op, v in p["per_op"].items() if k in op)
           for k in ("gather_slabs_kernel", "wavefront8_kernel")}
    log(f"profile walk decode u8 512x512x3: wall {p['wall_ms']:.4f} ms, device busy "
        f"{p['busy_ms']:.4f} ms (K7 {kms['gather_slabs_kernel']:.4f} ms, K5a "
        f"{kms['wavefront8_kernel']:.4f} ms), idle {p['idle']:.3f}, {p['ops']:.0f} device "
        f"ops, top {p['top'][:60]} {p['top_ms']:.4f} ms ({card})")
    return walk_launches


def in_turns(paths: dict, mb: float, runs: int = 3) -> dict:
    """Host-to-host MB/s of each path (a function whose result is on the
    host), each run once to warm up, then `runs` times in turns, the order
    reversed every other round -> name -> rates, sorted."""
    import torch

    names = list(paths)
    times = {k: [] for k in names}
    for name in names:
        paths[name]()
    for r in range(runs):
        for name in (names if r % 2 == 0 else names[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            paths[name]()
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t0)
    return {k: sorted(mb / t for t in v) for k, v in times.items()}


def rates_text(r: list) -> str:
    """Median MB/s and the range of the runs."""
    return f"median {r[len(r) // 2]:.2f} MB/s (runs {r[0]:.2f}-{r[-1]:.2f}, n={len(r)})"


class stage_times(dict):
    """Within the block, the host ms spent in each stage, summed over a
    run: targets, a list of (module or class, function name, stage), names
    the functions timed; by default the stages of pipeline.py and
    foreign.py, summed over a run's batches: plan (checks, sidecar parses,
    the flat layout; foreign's walks), layout (foreign's flat layout),
    inputs (the upload stage's host work), put (page-locked staging and the
    upload's enqueue), dispatch (the device work's enqueue), fetch (the
    page-locked buffers and the copies' enqueue), wait (on the fetch
    events) and finish (containers or arrays)."""

    def __init__(self, targets=None):
        super().__init__()
        self.targets = targets

    def __enter__(self):
        import functools

        from qb3_tpu_torch import foreign, pipeline

        def timed(name, fn):
            @functools.wraps(fn)
            def wrapper(*a, **kw):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    self[name] = self.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
            return wrapper

        names = {"_plan": "plan", "plan_decode": "plan", "plan_streams": "plan",
                 "flat_plan": "layout", "decode_inputs": "inputs", "upload_tiles": "inputs",
                 "encode_dispatch": "dispatch", "decode_dispatch": "dispatch",
                 "encode_finish": "finish", "decode_finish": "finish"}
        targets = self.targets or [(m, n, names.get(n, n)) for m, n in (
            (pipeline, "_plan"), (pipeline, "plan_decode"), (pipeline, "decode_inputs"),
            (pipeline, "upload_tiles"), (pipeline, "encode_dispatch"),
            (pipeline, "decode_dispatch"), (pipeline, "encode_finish"),
            (pipeline, "decode_finish"), (foreign, "plan_streams"), (foreign, "flat_plan"),
            (pipeline.Lanes, "put"), (pipeline.Lanes, "fetch"), (pipeline.Lanes, "wait"))]
        self.saved = [(m, n, m.__dict__[n]) for m, n, _ in targets]
        for (m, n, fn), (_, _, stage) in zip(self.saved, targets):
            if isinstance(fn, staticmethod):
                setattr(m, n, staticmethod(timed(stage, fn.__func__)))
            else:
                setattr(m, n, timed(stage, fn))
        return self

    def __exit__(self, *exc):
        for m, n, fn in self.saved:
            setattr(m, n, fn)


def stage_line(label: str, fn, card: str, targets=None):
    """One run of fn with its stages' host ms (stage_times)."""
    import torch

    with stage_times(targets) as ms:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        total = (time.perf_counter() - t0) * 1e3
    log(f"stages {label}: {total:.2f} ms host to host; "
        + ", ".join(f"{k} {v:.2f}" for k, v in ms.items()) + f" ms ({card})")


def serving_phase(dev, card, kernels) -> dict:
    """Phase 6, the serving paths (pipeline.py, foreign.py, cli.py), each
    main path with the launch counts set to 0 just before and read just
    after and every twin refused:
      * the pipelined "ic" encode and decode of 3 batches of 128 u8
        512x512x3 tiles (fill, steady state, drain; the first tile is the
        headline raster, its stream pinned), the streams equal to
        batch.encode_tiles', host-to-host MB/s beside the same batches
        through encode_tiles / decode_tiles one after another, the
        device's idle share, the peak device memory, each stage's host
        ms in one run (stage_times);
      * bench.py's pipelined row, 4 batches of 32 tiles, decoded with
        "ic", "ix" and the best modes' "ib" sidecars, beside decode_tiles;
      * the bulk decode of streams without a sidecar (bench.py's row: 4
        batches of 24 FTL streams; 24 RLE_H and 24 CF_H), one walker thread
        against the pool, split into the walks alone and walks + device,
        and its stages' host ms;
      * the CLI on the card in a temporary directory (u8 .npy and a 16-bit
        RGB PNG on pngio's own codec, -b, --index, -q +4, a folder,
        --trace) and profiling.meter.
    Returns the launch counts, kernel name -> count."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import torch

    import qb3_tpu_torch as qt
    from qb3_tpu_torch import batch, cli, container, foreign, pipeline, pngio, profiling
    from qb3_tpu_torch.benchutil import HEADLINE_SHA256, device_profile, headline_image
    from qb3_tpu_torch.constants import Mode

    t0 = time.perf_counter()
    seeds = [42] + [3000 + i for i in range(3 * BATCH - 1)]  # 42: headline_image()'s
    with ThreadPoolExecutor(os.cpu_count()) as ex:
        imgs = list(ex.map(lambda seed: headline_image(seed=seed), seeds))
    batches = [np.stack(imgs[k * BATCH:(k + 1) * BATCH]) for k in range(3)]
    log(f"serving inputs: {len(imgs)} u8 512x512x3 tiles in {time.perf_counter() - t0:.2f} s")
    launches = {}

    def counted(label, fn, want: dict):
        """fn() with the counts set to 0 just before, read just after, the
        twins refused and the peak device memory taken."""
        out = {}
        reset(kernels)
        with no_twins():
            peak = peak_bytes(lambda: out.update(v=fn()))
        got = {k: kernels[k].launches for k in want}
        log(f"launch counts on the {label} path: {got} (peak device memory "
            f"{peak / 2**20:.1f} MiB; {card})")
        check(got == want, f"{label}: launches {got}, want {want}")
        for k, n in got.items():
            launches[k] = launches.get(k, 0) + n
        return out["v"]

    def profile_line(label, fn):
        p = device_profile(fn, 1)
        log(f"profile {label}: wall {p['wall_ms']:.4f} ms, device active {p['active_ms']:.4f} "
            f"ms (busy {p['busy_ms']:.4f} summed over streams), idle share "
            f"{p['active_idle']:.3f}, {p['ops']:.0f} device ops, lost {p['lost']} ({card})")

    # the pipelined "ic" encode and decode at the main path's batch width
    def enc():
        return list(pipeline.encode_tiles_pipelined(iter(batches), index="ic", device=dev))

    streams = counted("pipelined ic encode (3 x 128)", enc,
                      {"phase_a_fast": 3, "pack_groups_chunked": 3})
    sha = hashlib.sha256(streams[0][0]).hexdigest()
    check(sha == HEADLINE_SHA256, f"pipelined headline sha256 {sha} != {HEADLINE_SHA256}")
    serial = [batch.encode_tiles(b, index="ic", device=dev) for b in batches]
    check(streams == serial, "pipelined streams differ from batch.encode_tiles'")

    def dec():
        return list(pipeline.decode_tiles_pipelined(iter(streams), device=dev))

    out = counted("pipelined ic decode (3 x 128)", dec,
                  {"extract_windows": 3, "chunkwalk8": 3})
    check(all(np.array_equal(d, b) for d, b in zip(out, batches)), "pipelined ic decode")
    del out, serial
    log(f"pipelined ic 3 x {BATCH}: headline stream sha256 {sha}, every stream equal to "
        "batch.encode_tiles', decoded to the tiles")
    mb = sum(b.nbytes for b in batches) / 1e6
    rates = in_turns({
        "encode pipelined": enc,
        "encode serial": lambda: [batch.encode_tiles(b, index="ic", device=dev)
                                  for b in batches],
        "decode pipelined": dec,
        "decode serial": lambda: [batch.decode_tiles(x, device=dev) for x in streams]}, mb)
    for name, r in rates.items():
        log(f"host-to-host ic 3 x {BATCH} {name}: {rates_text(r)} ({card})")
    stage_line(f"pipelined ic encode 3 x {BATCH}", enc, card)
    stage_line(f"pipelined ic decode 3 x {BATCH}", dec, card)
    profile_line(f"pipelined ic encode 3 x {BATCH}", enc)
    profile_line(f"serial ic encode 3 x {BATCH}",
                 lambda: [batch.encode_tiles(b, index="ic", device=dev) for b in batches])
    profile_line(f"pipelined ic decode 3 x {BATCH}", dec)
    profile_line(f"serial ic decode 3 x {BATCH}",
                 lambda: [batch.decode_tiles(x, device=dev) for x in streams])
    del streams

    # bench.py's pipelined row: 4 batches of 32 tiles, three sidecars
    row = [np.stack(imgs[k * ROW_TILES:(k + 1) * ROW_TILES]) for k in range(4)]
    mb = sum(b.nbytes for b in row) / 1e6
    ic = counted(f"pipelined ic encode (4 x {ROW_TILES})", lambda: list(
        pipeline.encode_tiles_pipelined(iter(row), index="ic", device=dev)),
        {"phase_a_fast": 4, "pack_groups_chunked": 4})
    ix = counted(f"pipelined ix encode (4 x {ROW_TILES})", lambda: list(
        pipeline.encode_tiles_pipelined(iter(row), index=True, device=dev)),
        {"phase_a_fast": 4, "pack_groups_chunked": 4})
    ib = [qt.encode_tiles(b, mode=Mode.CF_H, index=True, device=dev) for b in row]
    want = {"ic": {"extract_windows": 4, "chunkwalk8": 4}, "ix": {"wavefront_fused": 4},
            "ib": {"gather_slabs": 4, "wavefront8": 4}}
    for label, ss in (("ic", ic), ("ix", ix), ("ib", ib)):
        got = counted(f"pipelined {label} decode (4 x {ROW_TILES})",
                      lambda ss=ss: list(pipeline.decode_tiles_pipelined(iter(ss), device=dev)),
                      want[label])
        check(all(np.array_equal(d, b) for d, b in zip(got, row)), f"pipelined {label} decode")
        rates = in_turns({
            "pipelined": lambda ss=ss: list(pipeline.decode_tiles_pipelined(iter(ss),
                                                                           device=dev)),
            "serial": lambda ss=ss: [batch.decode_tiles(x, device=dev) for x in ss]}, mb)
        for name, r in rates.items():
            log(f"host-to-host {label} decode 4 x {ROW_TILES} {name}: {rates_text(r)} ({card})")
    rates = in_turns({
        "pipelined": lambda: list(pipeline.encode_tiles_pipelined(iter(row), index="ic",
                                                                  device=dev)),
        "serial": lambda: [batch.encode_tiles(b, index="ic", device=dev) for b in row]}, mb)
    for name, r in rates.items():
        log(f"host-to-host ic encode 4 x {ROW_TILES} {name}: {rates_text(r)} ({card})")
    del ic, ix, ib

    # the bulk decode of streams without a sidecar (the port's default encode)
    fb = [imgs[BATCH + FOREIGN_TILES * k:BATCH + FOREIGN_TILES * (k + 1)] for k in range(4)]
    fstreams = [qt.encode_tiles(np.stack(b), device=dev) for b in fb]
    check(fstreams[0][0] == qt.encode(fb[0][0], device=dev),
          "encode_tiles' FTL stream differs from the default encode's")
    out = counted(f"foreign FTL (4 x {FOREIGN_TILES})", lambda: list(
        foreign.decode_streams_pipelined(iter(fstreams), device=dev)),
        {"gather_slabs": 4, "wavefront8": 4})
    check(all(np.array_equal(d, np.stack(b)) for d, b in zip(out, fb)), "foreign FTL decode")
    nodata = [x.copy() for x in fb[0]]
    for x in nodata:  # a no-data area (phase 5's): zero runs, so every stream is RLE_H
        x[x.shape[0] // 8:5 * x.shape[0] // 8, 3 * x.shape[1] // 16:7 * x.shape[1] // 8] = 0
    extra = {"RLE_H": (nodata, [qt.encode(x, mode=Mode.RLE_H, device=dev) for x in nodata]),
             "CF_H": (fb[1], qt.encode_tiles(np.stack(fb[1]), mode=Mode.CF_H, device=dev))}
    for label, (b, ss) in extra.items():
        modes = {Mode(container.parse_headers(x).mode).name for x in ss}
        check(modes == {label}, f"foreign {label}: the streams' modes are {modes}")
        t, np_dt = counted(f"foreign {label} ({FOREIGN_TILES})", lambda ss=ss: foreign.decode_streams(
            ss, device=dev), {"gather_slabs": 1, "wavefront8": 1})
        check(t.is_cuda, f"foreign {label}: the tiles are not on the card")
        check(np.array_equal(t.cpu().numpy().view(np_dt), np.stack(b)),
              f"foreign {label} decode")
    one = foreign.decode_streams(fstreams[0], workers=1, device=dev)[0]
    pool = foreign.decode_streams(fstreams[0], device=dev)[0]
    check(torch.equal(one, pool), "foreign: one walker thread and the pool disagree")
    log(f"foreign bulk decode: 4 x {FOREIGN_TILES} FTL, {FOREIGN_TILES} RLE_H and "
        f"{FOREIGN_TILES} CF_H equal to the tiles; workers=1 equals the pool")
    flat = [x for b in fstreams for x in b]
    infos = [container.parse_headers(x) for x in flat]
    mb = sum(x.nbytes for b in fb for x in b) / 1e6

    def walks(workers):
        with ThreadPoolExecutor(workers) as ex:
            return list(ex.map(foreign._walk_one, flat, infos))

    def walks_device():
        for b in fstreams:
            t, _ = foreign.decode_streams(b, device=dev)
        torch.cuda.synchronize()

    rates = in_turns({
        "walks alone, 1 thread": lambda: walks(1),
        f"walks alone, pool ({os.cpu_count()} cores)": lambda: walks(None),
        "walks + device (no fetch)": walks_device,
        "pipelined, host to host": lambda: list(
            foreign.decode_streams_pipelined(iter(fstreams), device=dev)),
        "one-shot decode a stream": lambda: [qt.decode(x, device=dev) for x in flat]}, mb)
    for name, r in rates.items():
        log(f"foreign FTL 4 x {FOREIGN_TILES} {name}: {rates_text(r)} ({card})")
    stage_line(f"foreign FTL pipelined 4 x {FOREIGN_TILES}", lambda: list(
        foreign.decode_streams_pipelined(iter(fstreams), device=dev)), card)
    profile_line(f"foreign FTL pipelined 4 x {FOREIGN_TILES}", lambda: list(
        foreign.decode_streams_pipelined(iter(fstreams), device=dev)))
    del fstreams, extra, out

    # the CLI on the card
    img = imgs[0]
    rgb16 = headline_image(256, 256, 3, seed=9, dtype=np.uint16)
    with tempfile.TemporaryDirectory() as tmp:
        def run(*argv):
            check(cli.main([*argv, "--device", "cuda"]) == 0, f"cli {argv}")

        def back(path):  # the CLI writes u8 / u16 as PNG, on pngio's own codec here
            with open(path, "rb") as f:
                return pngio._read_pure(f.read())

        np.save(os.path.join(tmp, "a.npy"), img)
        pngio.write_png(os.path.join(tmp, "b.png"), rgb16)
        for name, flags in (("a", []), ("a-best", ["-b"]), ("a-ix", ["--index"]),
                            ("a-q4", ["-q", "+4"])):
            run(os.path.join(tmp, "a.npy"), os.path.join(tmp, f"{name}.qb3"), *flags)
            run("-d", os.path.join(tmp, f"{name}.qb3"), os.path.join(tmp, f"{name}.png"))
            err = np.abs(back(os.path.join(tmp, f"{name}.png")).astype(int) - img).max()
            check(err <= (2 if name == "a-q4" else 0), f"cli {name}: error {err}")
        run(os.path.join(tmp, "b.png"), os.path.join(tmp, "b.qb3"))
        run("-d", os.path.join(tmp, "b.qb3"), os.path.join(tmp, "b-out.png"))
        check(np.array_equal(back(os.path.join(tmp, "b-out.png")), rgb16), "cli 16-bit RGB PNG")
        folder = os.path.join(tmp, "folder")
        os.makedirs(folder)
        for i in range(2):
            np.save(os.path.join(folder, f"t{i}.npy"), imgs[1 + i])
        run(folder)
        for i in range(2):
            check(qt.decode(open(os.path.join(folder, f"t{i}.qb3"), "rb").read(),
                            device=dev)[0].tobytes() == imgs[1 + i].tobytes(),
                  f"cli folder t{i}")
        trace = os.path.join(tmp, "trace")
        run(os.path.join(tmp, "a.npy"), os.path.join(tmp, "t.qb3"), "--index", "--trace", trace)
        (name,) = os.listdir(trace)
        with open(os.path.join(trace, name)) as f:
            names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
        found = sorted(k for k in ("pack_groups_kernel", "encode_pack_image_kernel")
                       if any(k in n for n in names))
        check(found, "cli --trace: no kernel of the port in the trace")
        with profiling.meter(img.nbytes) as m:
            qt.encode(img, index="ic", device=dev)
        check(m.mbps > 0, "profiling.meter gave no rate")
    log(f"cli on the card: u8 .npy (FTL, -b, --index, -q +4), 16-bit RGB PNG, a folder; "
        f"--trace names {found}; profiling.meter {m.mbps:.2f} MB/s host to host ({card})")
    return launches


SHARDS = 4  # phase 7: shards on the one card (devices=["cuda:0"] * SHARDS)


def sharded_phase(dev, card, kernels, scases, img, tiles, wide_imgs) -> dict:
    """Phase 7, the sharded paths (parallel/sharded.py), SHARDS shards on
    one card unless named, each main path with the launch counts and the
    group's bytes set to 0 just before and read just after and every twin
    refused:
      * encode_sharded of the u8 4096x4096x3 FTL scene with "ic", "ix" and
        no sidecar, and in BASE_H with "ix", each byte-equal to the
        single-device encode; encode_fast_sharded_scatter equal to
        encode_fast_sharded;
      * the headline tile over 2, 4 and 8 shards with "ic" to
        HEADLINE_SHA256, in CF_H with "ib" to BEST_HEADLINE_SHA256["ib"],
        and the four wide rasters with "ix" to WIDE_SHA256;
      * the u16 4096x4096x1 scene in CF_H with "ib", byte-equal to the
        single-device encode;
      * decode_fast_sharded of the u8 scene's "ix" and "ic" streams and of
        the u16 scene's "ib" stream, each equal to its scene;
      * encode_tiles_sharded of the 128 u8 512x512x3 tiles over 2 x 2
        shards, each payload the single-device encode's (core bands 0, 1,
        2);
    then host-to-host MB/s of the sharded encodes and decodes beside the
    single-device ones (3 runs in turns), the device's idle share and the
    peak device memory of each.  Returns the launch counts, kernel name ->
    count."""
    import torch

    import qb3_tpu_torch as qt
    from qb3_tpu_torch import container
    from qb3_tpu_torch.benchutil import (BEST_HEADLINE_SHA256, HEADLINE_SHA256, WIDE_SHA256,
                                         device_profile)
    from qb3_tpu_torch.constants import Mode
    from qb3_tpu_torch.parallel import sharded
    from qb3_tpu_torch.parallel.sharded import ShardGroup

    one = torch.device("cuda", torch.cuda.current_device())

    def cards(n=SHARDS):
        return [one] * n

    scene8 = scases["u8 4096x4096x3 FTL"][0]
    scene16 = scases["u16 4096x4096x1 BASE_H"][0]
    t0 = time.perf_counter()
    ref = {index: qt.encode(scene8, index=index, device=dev) for index in ("ic", True, False)}
    ref["BASE_H"] = qt.encode(scene8, mode=Mode.BASE_H, index=True, device=dev)
    best16 = qt.encode(scene16, mode=Mode.CF_H, index=True, device=dev)
    mesh_ref = []
    for t in tiles:
        s = qt.encode(t, coreband=[0, 1, 2], device=dev)
        mesh_ref.append(s[container.parse_headers(s).data_offset:])
    log(f"sharded references: the single-device encodes in {time.perf_counter() - t0:.2f} s")
    launches = {}

    def counted(label, fn, want: dict, calls: int = 1):
        """fn() with the launch counts and the group's bytes set to 0 just
        before and read just after, the twins refused and the peak device
        memory taken."""
        out = {}
        reset(kernels)
        ShardGroup.bytes_moved = 0
        with no_twins():
            peak = peak_bytes(lambda: out.update(v=fn()))
        got = {k: f.launches for k, f in kernels.items() if f.launches}
        log(f"launch counts on the sharded {label} path: {got}; the group moved "
            f"{ShardGroup.bytes_moved / calls:.0f} B a call ({calls} calls); peak device "
            f"memory {peak / 2**20:.1f} MiB ({card})")
        check(got == want, f"sharded {label}: launches {got}, want {want}")
        for k, n in got.items():
            launches[k] = launches.get(k, 0) + n
        return out["v"]

    def scene_encodes():
        out = {index: sharded.encode_sharded(scene8, SHARDS, index=index, devices=cards())
               for index in ("ic", True, False)}
        out["BASE_H"] = sharded.encode_sharded(scene8, SHARDS, mode=Mode.BASE_H, index=True,
                                               devices=cards())
        fast = sharded.encode_fast_sharded(scene8, SHARDS, cband=(1, 1, 1), devices=cards())
        scatter = sharded.encode_fast_sharded_scatter(scene8, SHARDS, cband=(1, 1, 1),
                                                      devices=cards())
        return out, fast, scatter

    got, fast, scatter = counted("u8 4096x4096x3 encode (ic, ix, none, BASE_H ix, fast, "
                                 "scatter)", scene_encodes,
                                 {"pack_groups_chunked": 6 * SHARDS}, calls=6)
    for k, s in got.items():
        check(s == ref[k], f"sharded u8 scene {k}: the stream differs from the single "
                           "device's")
    check(fast[0] == scatter[0] == ref[False][container.parse_headers(ref[False]).data_offset:],
          "sharded u8 scene: encode_fast_sharded, the scatter stitch and the single-device "
          "payload differ")
    log(f"sharded u8 4096x4096x3 over {SHARDS} shards: ic, ix, no sidecar and BASE_H ix "
        "streams equal the single-device encode's; fast == scatter")

    def pins():
        out = {n: sharded.encode_sharded(img, n, index="ic", devices=cards(n))
               for n in (2, 4, 8)}
        out["best"] = sharded.encode_sharded(img, SHARDS, mode=Mode.CF_H, index=True,
                                             devices=cards())
        for label, x in wide_imgs.items():
            out[label] = sharded.encode_sharded(x, SHARDS, index=True, devices=cards())
        return out

    got = counted("pins (headline 2 / 4 / 8 shards, best headline, 4 wide)", pins,
                  {"pack_groups_chunked": 14 + 5 * SHARDS, "place_parts": 1},
                  calls=8)
    for n in (2, 4, 8):
        sha = hashlib.sha256(got[n]).hexdigest()
        check(sha == HEADLINE_SHA256, f"sharded headline over {n}: sha256 {sha}")
    sha = hashlib.sha256(got["best"]).hexdigest()
    check(sha == BEST_HEADLINE_SHA256["ib"], f"sharded best headline ib: sha256 {sha}")
    for label in wide_imgs:
        sha = hashlib.sha256(got[label]).hexdigest()
        check(sha == WIDE_SHA256[label], f"sharded wide {label} ix: sha256 {sha}")
    log("sharded pins: the headline over 2, 4 and 8 shards (ic), the best headline (CF_H ib) "
        "and the four wide ix streams match qb3_tpu's sha256s")

    got = counted("u16 4096x4096x1 CF_H ib encode", lambda: sharded.encode_sharded(
        scene16, SHARDS, mode=Mode.CF_H, index=True, devices=cards()),
        {"pack_groups_chunked": SHARDS, "place_parts": 1})
    check(got == best16, "sharded u16 scene CF_H ib: the stream differs from the single "
                         "device's")
    check(container.parse_headers(got).index_best is not None, "u16 scene: no ib sidecar")

    streams = {"u8 ix": (ref[True], scene8, {"gather_slabs": SHARDS, "wavefront8": SHARDS}),
               "u8 ic": (ref["ic"], scene8, {"extract_windows": SHARDS,
                                             "chunkwalk8": SHARDS}),
               "u16 CF_H ib": (best16, scene16, {"gather_slabs": SHARDS,
                                                 "wavefront_wide": SHARDS})}
    for label, (s, x, want) in streams.items():
        out = counted(f"{label} decode", lambda s=s: sharded.decode_fast_sharded(
            s, SHARDS, devices=cards()), want)
        check(np.array_equal(out, x), f"sharded {label} decode")
    log(f"sharded decodes over {SHARDS} shards: the u8 scene's ix and ic streams and the u16 "
        "scene's CF_H ib stream equal their scenes")

    got = counted(f"2-D mesh ({BATCH} tiles, 2 x 2)", lambda: sharded.encode_tiles_sharded(
        tiles, 2, 2, devices=cards(4)), {"pack_groups_chunked": 4, "place_parts": BATCH})
    check(got == mesh_ref, "2-D mesh: a payload differs from the single-device encode's")
    log(f"2-D mesh: {BATCH} u8 512x512x3 tiles over 2 x 2 shards equal the single-device "
        "payloads")

    # one run's host ms by stage: the uploads, the shards' run (their device
    # work's enqueue and the collectives' waits), the downloads, the host
    # assembly or K6 stitch, the shard windows and "ib" group inputs
    stages = [(sharded, "to_carrier", "upload"), (ShardGroup, "run", "run"),
              (sharded, "_host", "download"), (sharded, "from_carrier", "download"),
              (sharded, "assemble_scatter", "assemble"),
              (sharded, "stitch_words_device", "stitch"),
              (sharded, "_shard_windows", "windows"), (sharded, "group_inputs", "inputs")]
    stage_line(f"sharded u8 4096x4096x3 ic encode ({SHARDS} shards)",
               lambda: sharded.encode_sharded(scene8, SHARDS, index="ic", devices=cards()),
               card, stages)
    stage_line(f"sharded u16 4096x4096x1 CF_H ib encode ({SHARDS} shards)",
               lambda: sharded.encode_sharded(scene16, SHARDS, mode=Mode.CF_H, index=True,
                                              devices=cards()), card, stages)
    stage_line(f"sharded 2-D mesh encode ({BATCH} tiles, 2 x 2)",
               lambda: sharded.encode_tiles_sharded(tiles, 2, 2, devices=cards(4)), card, stages)
    with slab_stitch(True):  # the parent's device stitch, for the stitch stage
        stage_line(f"sharded u16 4096x4096x1 CF_H ib encode ({SHARDS} shards), slab route",
                   lambda: sharded.encode_sharded(scene16, SHARDS, mode=Mode.CF_H, index=True,
                                                  devices=cards()), card, stages)
        stage_line(f"sharded 2-D mesh encode ({BATCH} tiles, 2 x 2), slab route",
                   lambda: sharded.encode_tiles_sharded(tiles, 2, 2, devices=cards(4)), card,
                   stages)
    stage_line(f"sharded u8 4096x4096x3 ix decode ({SHARDS} shards)",
               lambda: sharded.decode_fast_sharded(ref[True], SHARDS, devices=cards()), card,
               stages)

    # host to host, sharded beside one device, in turns
    pairs = {
        "u8 4096x4096x3 ic encode": (scene8.nbytes, lambda: sharded.encode_sharded(
            scene8, SHARDS, index="ic", devices=cards()),
            lambda: qt.encode(scene8, index="ic", device=dev)),
        "u8 4096x4096x3 ic decode": (scene8.nbytes, lambda: sharded.decode_fast_sharded(
            ref["ic"], SHARDS, devices=cards()), lambda: qt.decode(ref["ic"], device=dev)),
        "u8 4096x4096x3 ix decode": (scene8.nbytes, lambda: sharded.decode_fast_sharded(
            ref[True], SHARDS, devices=cards()), lambda: qt.decode(ref[True], device=dev)),
        "u16 4096x4096x1 CF_H ib encode": (scene16.nbytes, lambda: sharded.encode_sharded(
            scene16, SHARDS, mode=Mode.CF_H, index=True, devices=cards()),
            lambda: qt.encode(scene16, mode=Mode.CF_H, index=True, device=dev)),
        "u16 4096x4096x1 CF_H ib decode": (scene16.nbytes, lambda: sharded.decode_fast_sharded(
            best16, SHARDS, devices=cards()), lambda: qt.decode(best16, device=dev)),
    }
    for label, (nbytes, shard_fn, one_fn) in pairs.items():
        rates = in_turns({"sharded": shard_fn, "one device": one_fn}, nbytes / 1e6)
        r_s, r_1 = rates["sharded"], rates["one device"]
        log(f"host-to-host {label}: {SHARDS} shards {rates_text(r_s)}, one device "
            f"{rates_text(r_1)}, ratio {r_s[len(r_s) // 2] / r_1[len(r_1) // 2]:.3f} ({card})")
        for name, fn in (("sharded", shard_fn), ("one device", one_fn)):
            p = device_profile(fn, 1)
            log(f"profile {label} {name}: wall {p['wall_ms']:.4f} ms, device active "
                f"{p['active_ms']:.4f} ms, idle share {p['active_idle']:.3f}, {p['ops']:.0f} "
                f"device ops, lost {p['lost']}; peak device memory "
                f"{peak_bytes(fn) / 2**20:.1f} MiB ({card})")
    return launches


# phase 8: cycles of each torch.cuda._sleep that sync must wait for (~50 ms
# at 1.98 GHz), the syncs after a trivial op whose median is the cost of one
SLEEP_CYCLES, SYNC_COSTS = 100_000_000, 200


def timing_phase(dev, card, paths: dict, img):
    """Phase 8, the timing helpers of benchutil and profiling: sync waits for
    a sleep on the current stream and one on a second stream, and returns
    without waiting for a tree of host leaves; the median cost of one sync
    after a trivial op; sustained_stats (3 windows of 30 and of 100 calls)
    on phase 5's device-resident "ic" paths beside sustained's; a
    profiling.trace(host=True) of an "ic" round trip names K1 and K2."""
    import tempfile

    import torch

    import qb3_tpu_torch as qt
    from qb3_tpu_torch import profiling
    from qb3_tpu_torch.benchutil import sustained, sustained_stats, sync

    streams = (torch.cuda.current_stream(), torch.cuda.Stream())

    def queue(cycles: int):
        """A sleep, an event and a tensor written after them on each stream."""
        events, outs = [], []
        for stream in streams:
            with torch.cuda.stream(stream):
                torch.cuda._sleep(cycles)
                events.append(torch.cuda.Event())
                events[-1].record()
                outs.append(torch.ones(1024, device=dev))
        return events, outs

    queue(1)  # loads the ops' kernels first: a lazy load waits for the whole card
    torch.cuda.synchronize()
    events, outs = queue(SLEEP_CYCLES)
    t0 = time.perf_counter()
    sync((np.zeros(4), b"host", [np.ones(2), 3]))
    t_host = time.perf_counter() - t0
    check(not any(e.query() for e in events), "sync of host leaves waited for the card")
    sync({"current": outs[0], "second": (outs[1],)})
    check(all(e.query() for e in events), "sync returned before a stream's sleep ended")
    x = torch.zeros(1, device=dev)
    costs = []
    for _ in range(SYNC_COSTS):
        x.add_(1)
        t0 = time.perf_counter()
        sync(x)
        costs.append(time.perf_counter() - t0)
    log(f"sync: waits for a sleep on the current and on a second stream; host leaves "
        f"return in {t_host * 1e6:.2f} us without waiting; one sync after a trivial op "
        f"{np.median(costs) * 1e6:.2f} us (median of {SYNC_COSTS}; quartiles "
        f"{np.percentile(costs, 25) * 1e6:.2f}-{np.percentile(costs, 75) * 1e6:.2f}) ({card})")

    for label, (fn, mb) in paths.items():
        ref = sustained(fn, 30)
        for iters in (30, 100):
            mean, sigma = sustained_stats(fn, iters, 3)
            check(mean > 0 and np.isfinite(sigma), f"sustained_stats {label}: {mean}, {sigma}")
            log(f"sustained_stats {label}, {iters} calls x 3 windows: {mean * 1e3:.4f} ms, "
                f"{mb / mean:.2f} MB/s, sigma {sigma * 100:.2f}%; sustained (events, 30 "
                f"calls) {ref * 1e3:.4f} ms, {mb / ref:.2f} MB/s ({card})")

    with tempfile.TemporaryDirectory() as tmp:
        with profiling.trace(tmp, host=True):
            stream = qt.encode(img, index="ic", device=dev)
            out, _ = qt.decode(stream, device=dev)
        check(np.array_equal(out, img), "traced ic round trip")
        (name,) = os.listdir(tmp)
        with open(os.path.join(tmp, name)) as f:
            names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    missing = [k for k in ("pack_groups_kernel", "chunkwalk_kernel")
               if not any(k in n for n in names)]
    check(not missing, f"profiling.trace(host=True): {missing} not in the trace")
    log("profiling.trace(host=True) of an ic round trip names K1 (pack_groups_kernel) "
        "and K2 (chunkwalk_kernel)")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    # the package beside this script (the checkout's root)
    sys.path.insert(0, ROOT)
    import qb3_tpu_torch as qt
    from qb3_tpu_torch import _build, api, probes
    from qb3_tpu_torch.benchutil import (HEADLINE_SHA256, WIDE_IMAGES, WIDE_SHA256,
                                         headline_image, host_seconds, sustained,
                                         wide_image)
    from qb3_tpu_torch.constants import HILBERT, Mode
    from qb3_tpu_torch.ops.chunkwalk_cuda import chunkwalk8
    from qb3_tpu_torch.ops.decode import decode_indexed_narrow, reconstruct, reconstruct_batch
    from qb3_tpu_torch.ops.encode_cuda import encode_pack_image, image_pack_args
    from qb3_tpu_torch.ops.encode_image import phase_a_image
    from qb3_tpu_torch.ops.fusedwin_cuda import wavefront_fused
    from qb3_tpu_torch.ops.gather_cuda import gather_slabs
    from qb3_tpu_torch.ops.pack_cuda import extract_windows, pack_groups_chunked
    from qb3_tpu_torch.ops.phase_a_cuda import phase_a_best, phase_a_fast
    from qb3_tpu_torch.ops.place_cuda import place_parts, place_slabs
    from qb3_tpu_torch.ops.quantize_cuda import quantize_carrier
    from qb3_tpu_torch.ops.wavefront_cuda import wavefront8, wavefront_wide

    dev = torch.device("cuda")
    card = card_line()
    log("# phase 1: card")
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")

    log("# phase 2: build")
    t0 = time.perf_counter()
    lib = _build.build()
    _build.load()
    log(f"built {os.path.relpath(lib, ROOT)} in {time.perf_counter() - t0:.2f} s")
    with open(lib + ".log") as f:
        for line in f:
            if "registers" in line or "spill" in line:
                log("  " + line.strip())
    launch_floor(dev)

    img = headline_image()
    tiles = np.stack([headline_image(seed=100 + i) for i in range(BATCH)])
    u16 = headline_image(1024, 1024, 1, seed=7, dtype=np.uint16)
    u64 = headline_image(256, 256, 1, seed=8, dtype=np.uint64)

    log("# phase 3: kernels against their twins")
    kres = k9_phase(dev, card, img, tiles)
    kres.update(k10_phase(dev, card, img))
    scene = dem_scene()
    kres.update(k11_phase(dev, card, scene))
    kres.update(kernel_phase(dev, card, img, tiles, u16))
    cases = ix_cases()
    ix_res, ix_streams = ix_kernel_phase(dev, card, cases)
    kres.update(ix_res)
    kres.update(k8_phase(dev, card))
    photo = photo_image()
    kres.update(k8_photo_phase(dev, card, photo))
    best_streams = best_ib_streams(dev, tiles)
    kres.update(k7_phase(dev, card, img, wide_image("u64 1024x1024x1"), best_streams))
    for name, err in {**k5_phase(dev, card, best_streams),
                      **walk_edge_phase(dev, card)}.items():
        kres[name] = (max(err, kres[name][0]),) + kres[name][1:]
    del best_streams
    scases = strip_cases()
    kres.update(k6_phase(dev, card, {
        "u8 4096x4096x3 FTL": (scases["u8 4096x4096x3 FTL"][0], Mode.FTL),
        "u16 4096x4096x1 CF_H": (scases["u16 4096x4096x1 BASE_H"][0], Mode.CF_H)}))
    kres.update(probe_phase(dev, card))
    best_imgs = {"u8 512x512x3": img, "u64 1024x1024x1": wide_image("u64 1024x1024x1")}
    kres.update(k1_best_phase(dev, card, best_imgs))

    log("# phase 4: golden bytes")
    fixture_phase(dev)
    best_pins(dev, img)
    stream = qt.encode(img, index="ic", device=dev)
    sha = hashlib.sha256(stream).hexdigest()
    check(sha == HEADLINE_SHA256, f"headline sha256 {sha} != {HEADLINE_SHA256}")
    log(f"headline 512x512x3 u8 ic stream sha256 {sha}: matches qb3_tpu")
    wide_imgs = {label: wide_image(label) for label in WIDE_IMAGES}
    for label, x in wide_imgs.items():
        sha = hashlib.sha256(qt.encode(x, index=True, device=dev)).hexdigest()
        check(sha == WIDE_SHA256[label], f"{label} ix sha256 {sha} != {WIDE_SHA256[label]}")
    log(f"wide ix streams ({', '.join(wide_imgs)}), through the image-layout encode: "
        "sha256s match qb3_tpu")

    kernels = {"pack_groups_chunked": pack_groups_chunked,
               "extract_windows": extract_windows, "chunkwalk8": chunkwalk8,
               "wavefront_fused": wavefront_fused, "wavefront8": wavefront8,
               "wavefront_wide": wavefront_wide, "gather_slabs": gather_slabs,
               "encode_pack_image": encode_pack_image, "place_slabs": place_slabs,
               "place_parts": place_parts, "phase_a_fast": phase_a_fast,
               "phase_a_best": phase_a_best, "quantize_carrier": quantize_carrier,
               **{f"probe_{n}": k for n, (k, _) in probes.KERNELS.items()}}
    landsat_pin(dev, card, kernels)

    log("# phase 5: main paths")
    ic_path = ("phase_a_fast", "pack_groups_chunked", "extract_windows", "chunkwalk8")
    ix_path = ("pack_groups_chunked", "wavefront_fused", "wavefront8", "wavefront_wide")
    reset(kernels)
    stream = qt.encode(img, index="ic", device=dev)
    dec = qt.Decoder(stream, device=dev)
    check(np.array_equal(dec.read_data(), img) and dec.decode_path == "ic",
          "single-image round trip")
    streams = qt.encode_tiles(tiles, index="ic", device=dev)
    check(streams[0] == qt.encode(tiles[0], index="ic", device=dev),
          "batch stream differs from a single encode")
    check(np.array_equal(qt.decode_tiles(streams, device=dev), tiles),
          "batch round trip")
    wide = {}
    for name, x in (("u16 1024x1024x1", u16), ("u64 256x256x1", u64)):
        s = qt.encode(x, index="ic", device=dev)
        d = qt.Decoder(s, device=dev)
        check(np.array_equal(d.read_data(), x) and d.decode_path == "ic",
              f"{name} round trip")
        wide[name] = len(s) / x.nbytes
    launches = {name: kernels[name].launches for name in ic_path}
    log(f"launch counts on the ic path: {launches}")
    check(all(n > 0 for n in launches.values()), "a kernel of the ic path was not launched")
    log(f"lossless ic: 512x512x3 u8 single (ratio {len(stream) / img.nbytes:.4f}), "
        f"batch of {BATCH}, " + ", ".join(f"{k} (ratio {v:.4f})" for k, v in wide.items()))

    reset(kernels)
    for label, x in cases.items():
        if x.shape[0] == 1:
            s = qt.encode(x[0], index=True, device=dev)
            check(s == ix_streams[label][0], f"ix {label}: stream differs from the batch's")
            d = qt.Decoder(s, device=dev)
            check(np.array_equal(d.read_data(), x[0]) and d.decode_path == "ix",
                  f"ix {label} round trip")
        else:
            ss = qt.encode_tiles(x, index=True, device=dev)
            check(ss == ix_streams[label], f"ix {label}: streams differ")
            check(np.array_equal(qt.decode_tiles(ss, device=dev), x), f"ix {label} round trip")
        log(f"lossless ix: {label} (ratio "
            f"{sum(map(len, ix_streams[label])) / x.nbytes:.4f})")
    for label in ("u8 512x512x3", "u64 1024x1024x1"):
        # the K5 branch (no fused params), as the TPU runs it without them
        a = ix_inputs(ix_streams[label], dev)
        args = (a["words32"], a["glens"], a["nblocks"], a["nb"], False, a["tbits"])
        check(torch.equal(decode_indexed_narrow(*args, nreg=a["nreg"]),
                          decode_indexed_narrow(*args, nreg=a["nreg"], fused=a["R"])),
              f"ix {label}: the K5 branch disagrees with K4")
    ix_launches = {name: kernels[name].launches for name in ix_path}
    log(f"launch counts on the ix path: {ix_launches}")
    check(all(n > 0 for n in ix_launches.values()), "a kernel of the ix path was not launched")
    launches.update({k: v for k, v in ix_launches.items() if k not in launches})

    # the public encode of the wide shapes (the image-layout encode): the
    # "ix" streams are qb3_tpu's (phase 4's sha256s), both sidecars round-trip,
    # through K8 and never K9 or K1
    reset(kernels)
    for label, x in wide_imgs.items():
        for index in (True, "ic"):
            s = qt.encode(x, index=index, device=dev)
            if index is True:
                check(hashlib.sha256(s).hexdigest() == WIDE_SHA256[label],
                      f"wide {label}: ix stream differs from qb3_tpu's")
            d = qt.Decoder(s, device=dev)
            check(np.array_equal(d.read_data(), x)
                  and d.decode_path == ("ix" if index is True else "ic"),
                  f"wide {label} {index} round trip")
    wide_launches = {name: kernels[name].launches
                     for name in ("encode_pack_image", "phase_a_fast", "pack_groups_chunked")}
    log(f"launch counts on the wide encode path: {wide_launches}")
    check(wide_launches["encode_pack_image"] > 0, "K8 was not launched on the wide path")
    check(wide_launches["phase_a_fast"] == 0, "K9 ran on the wide path")
    check(wide_launches["pack_groups_chunked"] == 0, "K1 ran on the wide path")
    log(f"lossless wide: {', '.join(wide_imgs)} (ix and ic round trips)")
    launches["encode_pack_image"] = wide_launches["encode_pack_image"]


    raw_mb = img.nbytes / 1e6
    zero = torch.zeros(3, dtype=torch.int64, device=dev)
    n_words = api.stream_words(512, 512, 3, 0)
    img_dev = torch.from_numpy(img).to(dev)
    tiles_dev = torch.from_numpy(tiles).to(dev)
    zb = torch.zeros(BATCH, 3, dtype=torch.int64, device=dev)
    a1 = walk_inputs([stream], dev)
    ab = walk_inputs(streams, dev)

    def dec_dev(a):
        return api.ic_decode(a, a["nblocks"], 3, 512, 512, HILBERT, a["cband"], False,
                             8).to(torch.uint8)

    def dec_batch():
        from qb3_tpu_torch.ops.decode import reconstruct_batch
        from qb3_tpu_torch.ops.decode_chunked import decode_chunked_auto

        nch = -(-ab["nblocks"] // ab["k"])
        g = decode_chunked_auto(ab["words32"], ab["starts"], ab["entry"], ab["k"],
                                BATCH * nch * ab["k"], 3, False, 8, ab["maxw"], ab["R"])
        g = g.reshape(BATCH, nch * ab["k"], 3, 16)[:, :ab["nblocks"]]
        return reconstruct_batch(g, 512, 512, 3, HILBERT, ab["cband"], 8).to(torch.uint8)

    check(torch.equal(dec_dev(a1).cpu(), torch.from_numpy(img)), "device decode")
    # the device-resident "ic" paths (name -> function, MB a call), timed
    # again by phase 8
    ic_paths = {
        "device encode single": (lambda z=zero: api.fast_encode(
            img_dev.to(torch.int64), z, z, HILBERT, (1, 1, 1), True, 8, n_words), raw_mb),
        "device decode single": (lambda: dec_dev(a1), raw_mb),
        f"device encode batch{BATCH}": (lambda: api.fast_encode(
            tiles_dev.to(torch.int64), zb, zb, HILBERT, (1, 1, 1), True, 8, n_words,
            lanewise=True), raw_mb * BATCH),
        f"device decode batch{BATCH}": (dec_batch, raw_mb * BATCH),
    }
    rates = {
        **{name: mb / sustained(fn, 3 if "batch" in name else 20)
           for name, (fn, mb) in ic_paths.items()},
        "host-to-host encode single": raw_mb / host_seconds(
            lambda: qt.encode(img, index="ic", device=dev)),
        "host-to-host decode single": raw_mb / host_seconds(
            lambda: qt.decode(stream, device=dev)),
    }
    for name, r in rates.items():
        log(f"{name}: {r:.2f} MB/s ({card})")

    for label, x in cases.items():
        # device-resident "ix" decode: stream words + sidecar on the card to
        # the raster on the card, and its split into walk and reconstruct
        a = ix_inputs(ix_streams[label], dev)
        n, nb, tb = a["ntiles"], a["nb"], a["tbits"]
        zero = torch.zeros(nb, dtype=torch.int64, device=dev)

        def walk(a=a):
            return decode_indexed_narrow(a["words32"], a["glens"], a["nblocks"], nb, False, tb,
                                         n, a["tw32"], a["nreg"], fused=a["R"])

        def recon(g, a=a, zero=zero):
            if n == 1:
                img_, _ = reconstruct(g.reshape(a["nblocks"], nb, 16), zero, a["h"], a["w"],
                                      nb, HILBERT, a["cband"], tb)
            else:
                img_ = reconstruct_batch(g.reshape(n, a["nblocks"], nb, 16), a["h"], a["w"],
                                         nb, HILBERT, a["cband"], tb)
            return img_.to(api._TORCH_SIGNED[tb // 8])

        g = walk()
        check(np.array_equal(recon(g).cpu().numpy().view(x.dtype).reshape(x.shape), x),
              f"ix {label}: device decode")
        iters = 20 if x.nbytes < 4e6 else 5
        t_walk = sustained(walk, iters)
        t_rec = sustained(lambda: recon(g), iters)
        t_all = sustained(lambda: recon(walk()), iters)
        log(f"device decode ix {label}: {x.nbytes / 1e6 / t_all:.2f} MB/s; "
            f"{t_all * 1e3:.4f} ms = group starts + K4 {t_walk * 1e3:.4f} ms, "
            f"reconstruct {t_rec * 1e3:.4f} ms ({card})")
        del g

    for label, x in wide_imgs.items():
        # device-resident encode, the block encode (phase A + K1) against the
        # image-layout one (its phase A + K8) that the public encode takes:
        # equal outputs; the int64 carrier on the card to the stream words
        # on the card
        tb = 8 * x.itemsize
        nb = x.shape[2]
        xd = api.to_carrier(x, dev)
        zero = torch.zeros(nb, dtype=torch.int64, device=dev)
        enc = (xd, zero, zero, HILBERT, tuple(api.default_cband(nb)), True, tb, n_words_for(x))
        block, image = api.fast_encode(*enc), api.fused_encode(*enc)
        used = (int(block[1]) + 31) // 32
        check(torch.equal(block[0][:used], image[0][:used])
              and all(torch.equal(a, b) for a, b in zip(block[1:], image[1:])),
              f"wide {label}: the block and image-layout encodes disagree")
        args = image_pack_args(phase_a_image(*enc[:-1]), tb, enc[-1], HILBERT)
        paths = {"block": api.fast_encode, "image-layout": api.fused_encode}
        times = {"block": [], "image-layout": []}
        for name in ("block", "image-layout", "image-layout", "block"):  # in turns
            times[name].append(sustained(lambda: paths[name](*enc), 20))
        t_def, t_fus = (sum(times[k]) / 2 for k in paths)
        t_pa = sustained(lambda: phase_a_image(*enc[:-1]), 20)
        t_k8 = sustained(lambda: encode_pack_image(*args), 20)
        mb = x.nbytes / 1e6
        log(f"device encode {label}: block {mb / t_def:.2f} MB/s ({t_def * 1e3:.4f} ms), "
            f"image-layout {mb / t_fus:.2f} MB/s ({t_fus * 1e3:.4f} ms; alone, phase A "
            f"{t_pa * 1e3:.4f} ms and K8 {t_k8 * 1e3:.4f} ms); equal outputs ({card})")
        for name, fn in paths.items():
            p = profiled(lambda fn=fn: fn(*enc))
            pack = sum(v for k, v in p["per_op"].items()
                       if "pack_groups_kernel" in k or "encode_pack_image_kernel" in k)
            log(f"profile {name} encode {label}: wall {p['wall_ms']:.4f} ms, device busy "
                f"{p['busy_ms']:.4f} ms (pack kernel {pack:.4f} ms), idle {p['idle']:.3f}, "
                f"{p['ops']:.0f} device ops, top {p['top'][:60]} {p['top_ms']:.4f} ms ({card})")
        del xd, block, image, args

    walked = walk_phase(dev, card, img, wide_imgs, kernels, stream, ix_streams["u8 512x512x3"][0])
    stripped = strip_phase(dev, card, kernels, scases)
    for k in ("gather_slabs", "wavefront8", "wavefront_wide"):  # K5 also ran on the ix path
        launches[k] = launches.get(k, 0) + walked[k] + stripped[k]
    launches["place_slabs"] = stripped["place_slabs"]
    launches["place_parts"] = stripped["place_parts"]
    launches["phase_a_fast"] += stripped["phase_a_fast"]
    best_k1, best_launches = best_phase(dev, card, kernels, best_imgs, tiles,
                                        scases["u16 4096x4096x1 BASE_H"][0])
    for k, n in best_launches.items():
        launches[k] = launches.get(k, 0) + n
    launches["quantize_carrier"] = dem_phase(dev, card, kernels, scene)
    del scene
    photo_launches = photo_phase(dev, card, kernels, photo)
    for k, n in photo_launches.items():
        launches[k] = launches.get(k, 0) + n
    del photo
    landsat_split(dev, card)
    launches.update(probe_main_path(kernels))

    log("# phase 6: serving paths")
    for k, n in serving_phase(dev, card, kernels).items():
        launches[k] = launches.get(k, 0) + n

    log("# phase 7: sharded paths")
    t0 = time.perf_counter()
    for k, n in sharded_phase(dev, card, kernels, scases, img, tiles, wide_imgs).items():
        launches[k] = launches.get(k, 0) + n
    log(f"phase 7 took {time.perf_counter() - t0:.2f} s")

    log("# phase 8: timing helpers")
    t0 = time.perf_counter()
    timing_phase(dev, card, ic_paths, img)
    log(f"phase 8 took {time.perf_counter() - t0:.2f} s")

    def entry(name: str, kernel: str, n: int) -> dict:
        """The kernels line's entry of kres[name], a run of KERNELS[kernel]
        launched n times on the main path."""
        # device ms (profiled: K1-K4, K6-K8, P1-P7; K1, K2, K4, K6 and K8 all they issue)
        # and the library call's, else None
        err, ms, plain, need, lib, dev_ms, lib_dev = (*kres[name], None, None)[:7]
        # bound_by names the larger work term, bound_term what sets bound_ms
        # (the floor where it is larger than both)
        bms, term = bound(need)
        t_bytes, t_ops = work_ms(need)
        return {"name": name, "route": "cuda", "source": KERNELS[kernel][0],
                "replaces": KERNELS[kernel][1], "launches": n, "max_abs_err": err, "ms": ms,
                "plain_ms": plain, "bound_ms": bms,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bound_term": term, "library_ms": lib, "device_ms": dev_ms,
                "library_device_ms": lib_dev, "floor_ms": FLOOR_MS}

    line = [entry(name, name, launches[name]) for name in KERNELS]
    # K1 at the best modes' symbol counts
    line += [entry(name, "pack_groups_chunked", best_k1[name]) for name in BEST_K1]
    # K6's stitch entry, launched by every device stitch
    line.append(entry("place_slabs stitch", "place_slabs", launches["place_parts"]))
    # K8 at the photo cell's strip, launched by the photo's strip and one-shot encodes
    line.append(entry(PHOTO_K8, "encode_pack_image", photo_launches["encode_pack_image"]))
    log(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
