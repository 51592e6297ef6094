#!/usr/bin/env python3
"""Smoke run of qb3_tpu_torch's main path on one CUDA card (an H100).

    python3 chip_smoke.py

The main paths: FTL encode of a 512x512x3 u8 raster with the self-contained
"ic" sidecar, then decode driven by that sidecar, one image at a time and as
a batch of 128 tiles; and the "ix" sidecar encode and decode at the shapes
of the bench rows it serves (u8 512x512x3 single and 128 tiles, u16
1024x1024x1, u16 512x512x8, u32 and u64 1024x1024x1, u64 8 tiles).  Phases,
each printed on earlier lines:

  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build the CUDA kernels from qb3_tpu_torch/csrc, one nvcc per source;
  3. K1 (pack), K3 (window copy) and K2 (chunk walk) at the "ic" path's
     shapes, then K4 (fused "ix" walk, both modes), K5a and K5b (walks on
     gathered windows) at the "ix" shapes, each against its plain PyTorch
     twin: exact equality, median times;
  4. golden bytes: the committed web fixtures (streams pinned to the C
     reference) re-encoded by the port, and the headline stream's sha256;
  5. the main paths through the public API with the launch counters reset:
     "ic" single image, 128-tile batch, u16 1024x1024x1 and u64 256x256x1
     round trips, "ix" round trips at every "ix" shape and the K5 branch of
     decode_indexed_narrow; then device-resident and host-to-host MB/s, and
     the "ix" decode's device time split into K4 and reconstruct.

Any failure exits non-zero and prints no result.  The line before the last
is {"kernels": [...]}, the last {"ok": true, "device": {...}}.  It needs a
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
KERNELS = {  # name -> (source in the repo, file:line of the TPU kernel's pallas_call)
    "pack_groups_chunked": ("qb3_tpu_torch/csrc/pack.cu", "qb3_tpu/ops/pack_pallas.py:228"),
    "extract_windows": ("qb3_tpu_torch/csrc/pack.cu", "qb3_tpu/ops/pack_pallas.py:295"),
    "chunkwalk8": ("qb3_tpu_torch/csrc/chunkwalk.cu", "qb3_tpu/ops/chunkwalk_pallas.py:211"),
    "wavefront_fused": ("qb3_tpu_torch/csrc/fusedwin.cu", "qb3_tpu/ops/fusedwin_pallas.py:423"),
    "wavefront8": ("qb3_tpu_torch/csrc/wavefront.cu", "qb3_tpu/ops/wavefront_pallas.py:129"),
    "wavefront_wide": ("qb3_tpu_torch/csrc/wavefront.cu", "qb3_tpu/ops/wavefront_pallas.py:284"),
}


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


def compare(name, got, want):
    """Exact equality of kernel and twin outputs -> max abs difference."""
    import torch

    err = 0
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        check(g.shape == w.shape, f"{name}: shape {tuple(g.shape)} vs {tuple(w.shape)}")
        d = (g.to(torch.int64) - w.to(torch.int64)).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
    check(err == 0, f"{name}: kernel disagrees with its twin (max abs err {err})")
    return err


def kernel_phase(dev, img, tiles, u16):
    """Phase 3: each kernel against its twin at the main path's shapes."""
    import torch

    from qb3_tpu_torch import api
    from qb3_tpu_torch.benchutil import median_ms
    from qb3_tpu_torch.constants import HILBERT
    from qb3_tpu_torch.ops import bitpack, pack_cuda
    from qb3_tpu_torch.ops.chunkwalk_cuda import chunkwalk8, chunkwalk8_plain
    from qb3_tpu_torch.ops.encode import encode_fast_blocks

    results = {}
    n_words = (api.max_encoded_size(512, 512, 3, 0) + 3) // 4 + 2
    maxbits = bitpack.group_bits_bound(8, best=False)
    for label, x in (("single", img), (f"batch{BATCH}", tiles)):
        lead = x.shape[:-3]
        zero = torch.zeros(*lead, 3, dtype=torch.int64, device=dev)
        codes, lens, _, _ = encode_fast_blocks(api.to_carrier(x, dev), zero, zero,
                                               HILBERT, (1, 1, 1), True, 8,
                                               lanewise=bool(lead))
        args = (codes, lens, n_words, maxbits)
        err = compare("pack_groups_chunked", pack_cuda.pack_groups_chunked(*args),
                      bitpack.pack_groups(*args))
        ms = median_ms(lambda: pack_cuda.pack_groups_chunked(*args))
        plain = median_ms(lambda: bitpack.pack_groups(*args), 5)
        log(f"K1 pack_groups_chunked {label} codes {tuple(codes.shape)}: equal, "
            f"kernel {ms:.4f} ms, twin {plain:.4f} ms")
        results.setdefault("pack_groups_chunked", (err, ms, plain))
        del codes, lens

    cases = (("single u8", [api.encode(img, index="ic", device=dev)], 3),
             (f"batch{BATCH} u8", None, 3),
             ("1024x1024 u16", [api.encode(u16, index="ic", device=dev)], 4))
    for label, streams, ubits in cases:
        if streams is None:
            from qb3_tpu_torch.batch import encode_tiles
            streams = encode_tiles(tiles, index="ic", device=dev)
        a = walk_inputs(streams, dev)
        wargs = (a["words32"], a["wrow"], a["R"])
        win = pack_cuda.extract_windows(*wargs)
        err3 = compare("extract_windows", win, pack_cuda.extract_windows_plain(*wargs))
        ms3 = median_ms(lambda: pack_cuda.extract_windows(*wargs))
        plain3 = median_ms(lambda: pack_cuda.extract_windows_plain(*wargs), 5)
        log(f"K3 extract_windows {label} windows {tuple(win.shape)}: equal, "
            f"kernel {ms3:.4f} ms, twin {plain3:.4f} ms")
        cargs = (a["words32"], win, a["wrow"], a["starts"], a["entry"], a["k"],
                 a["nb"], False, ubits)
        err2 = compare("chunkwalk8", chunkwalk8(*cargs), chunkwalk8_plain(*cargs))
        ms2 = median_ms(lambda: chunkwalk8(*cargs))
        plain2 = median_ms(lambda: chunkwalk8_plain(*cargs), 3)
        log(f"K2 chunkwalk8 {label} ubits {ubits} chunks {a['starts'].shape[0]}: "
            f"equal, kernel {ms2:.4f} ms, twin {plain2:.4f} ms")
        results.setdefault("extract_windows", (err3, ms3, plain3))
        results.setdefault("chunkwalk8", (err2, ms2, plain2))
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


def ix_kernel_phase(dev, cases):
    """Phase 3b: K4 (both modes), K5a and K5b against their twins at the
    "ix" shapes.  Returns (per-kernel results, {label: streams})."""
    import torch

    from qb3_tpu_torch import batch
    from qb3_tpu_torch.benchutil import median_ms
    from qb3_tpu_torch.ops.decode import ix_parse, ix_regs
    from qb3_tpu_torch.ops.fusedwin_cuda import wavefront_fused, wavefront_fused_plain
    from qb3_tpu_torch.ops.wavefront_cuda import (wavefront8, wavefront8_plain,
                                                  wavefront_wide, wavefront_wide_plain)

    results, all_streams = {}, {}
    for label, tiles in cases.items():
        streams = batch.encode_tiles(tiles, index=True, device=dev)
        all_streams[label] = streams
        a = ix_inputs(streams, dev)
        tb, nreg = a["tbits"], a["nreg"]
        k4 = (a["words32"], a["goff"], nreg, a["R"], tb)
        kw = dict(nbands=a["nb"], per_tile=a["per_tile"])
        err4 = compare("wavefront_fused", wavefront_fused(*k4, **kw),
                       wavefront_fused_plain(*k4[:3], tb, **kw))
        ms4 = median_ms(lambda: wavefront_fused(*k4, **kw))
        plain4 = median_ms(lambda: wavefront_fused_plain(*k4[:3], tb, **kw), 3)
        regs = ix_regs(a["words32"], a["goff"], nreg)
        off, rung, kind = (x.to(torch.int32) for x in
                           ix_parse(regs, a["goff"], tb, a["nb"], a["per_tile"]))
        given = dict(off=off, rung=rung, kind=kind)
        err4 = max(err4, compare("wavefront_fused", wavefront_fused(*k4, **given),
                                 wavefront_fused_plain(*k4[:3], tb, **given)))
        log(f"K4 wavefront_fused {label} groups {a['goff'].shape[0]} nreg {nreg} R {a['R']}: "
            f"equal in both modes, kernel {ms4:.4f} ms, twin {plain4:.4f} ms")
        k5 = (regs[:, :nreg].to(torch.int32).contiguous(), off, rung, kind, nreg)
        if tb == 8:
            name, kern, plain = "wavefront8", wavefront8, wavefront8_plain
        else:
            name = "wavefront_wide"
            k5 = k5 + (tb,)
            kern, plain = wavefront_wide, wavefront_wide_plain
        err5 = compare(name, kern(*k5), plain(*k5))
        ms5 = median_ms(lambda: kern(*k5))
        plain5 = median_ms(lambda: plain(*k5), 3)
        log(f"K5 {name} {label}: equal, kernel {ms5:.4f} ms, twin {plain5:.4f} ms")
        for kname, res in (("wavefront_fused", (err4, ms4, plain4)), (name, (err5, ms5, plain5))):
            if kname in results:  # keep the first shape's times, the worst error
                res = (max(res[0], results[kname][0]),) + results[kname][1:]
            results[kname] = res
        del regs, k5, given
    return results, all_streams


def fixture_phase(dev):
    """Phase 4a: the web fixtures, re-encoded by the port."""
    from qb3_tpu_torch import api, container
    from qb3_tpu_torch.constants import Mode, is_best_mode

    with open(os.path.join(ROOT, "web", "test", "fixtures.js")) as f:
        text = f.read()
    cases = json.loads(text[text.index("["): text.rindex("]") + 1])
    check(len(cases) >= 20, f"only {len(cases)} web fixtures")
    matched = 0
    for c in cases:
        stream = base64.b64decode(c["stream"])
        info = container.parse_headers(stream)
        if is_best_mode(info.mode):
            log(f"fixture {c['name']}: left out, best mode is not ported "
                "(ROADMAP.md Queue 1 item 12)")
            continue
        raw = np.frombuffer(base64.b64decode(c["raw"]), np.dtype(c["dtype"]))
        raw = raw.reshape(c["shape"])
        mode = Mode.FTL if info.mode == Mode.STORED else info.mode
        got = api.encode(raw, mode=mode, quanta=info.quanta, coreband=info.cband,
                         index="ic" if info.index_chunked else False, device=dev)
        if got != stream:
            check(info.quanta > 1, f"fixture {c['name']}: port bytes differ")
            log(f"fixture {c['name']}: left out, its dequantized raw does not "
                "re-quantize to the stream's values")
            continue
        matched += 1
        if info.index_chunked:
            dec, _ = api.decode(stream, device=dev)
            check(dec.tobytes() == raw.tobytes(), f"fixture {c['name']}: decode differs")
            log(f"fixture {c['name']}: port decode equals raw")
    log(f"fixtures: {matched} of {len(cases)} streams re-encoded byte-exact")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    # the package beside this script (the checkout's root)
    sys.path.insert(0, ROOT)
    import qb3_tpu_torch as qt
    from qb3_tpu_torch import _build, api
    from qb3_tpu_torch.benchutil import (HEADLINE_SHA256, headline_image,
                                         host_seconds, sustained)
    from qb3_tpu_torch.constants import HILBERT
    from qb3_tpu_torch.ops.chunkwalk_cuda import chunkwalk8
    from qb3_tpu_torch.ops.decode import decode_indexed_narrow, reconstruct, reconstruct_batch
    from qb3_tpu_torch.ops.fusedwin_cuda import wavefront_fused
    from qb3_tpu_torch.ops.pack_cuda import extract_windows, pack_groups_chunked
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

    img = headline_image()
    tiles = np.stack([headline_image(seed=100 + i) for i in range(BATCH)])
    u16 = headline_image(1024, 1024, 1, seed=7, dtype=np.uint16)
    u64 = headline_image(256, 256, 1, seed=8, dtype=np.uint64)

    log("# phase 3: kernels against their twins")
    kres = kernel_phase(dev, img, tiles, u16)
    cases = ix_cases()
    ix_res, ix_streams = ix_kernel_phase(dev, cases)
    kres.update(ix_res)

    log("# phase 4: golden bytes")
    fixture_phase(dev)
    stream = qt.encode(img, index="ic", device=dev)
    sha = hashlib.sha256(stream).hexdigest()
    check(sha == HEADLINE_SHA256, f"headline sha256 {sha} != {HEADLINE_SHA256}")
    log(f"headline 512x512x3 u8 ic stream sha256 {sha}: matches qb3_tpu")

    log("# phase 5: main paths")
    kernels = {"pack_groups_chunked": pack_groups_chunked,
               "extract_windows": extract_windows, "chunkwalk8": chunkwalk8,
               "wavefront_fused": wavefront_fused, "wavefront8": wavefront8,
               "wavefront_wide": wavefront_wide}
    ic_path = ("pack_groups_chunked", "extract_windows", "chunkwalk8")
    ix_path = ("pack_groups_chunked", "wavefront_fused", "wavefront8", "wavefront_wide")
    for fn in kernels.values():
        fn.launches = 0
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

    for fn in kernels.values():
        fn.launches = 0
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

    raw_mb = img.nbytes / 1e6
    zero = torch.zeros(3, dtype=torch.int64, device=dev)
    n_words = (api.max_encoded_size(512, 512, 3, 0) + 3) // 4 + 2
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
    rates = {
        "device encode single": raw_mb / sustained(lambda: api.fast_encode(
            img_dev.to(torch.int64), zero, zero, HILBERT, (1, 1, 1), True, 8, n_words), 20),
        "device decode single": raw_mb / sustained(lambda: dec_dev(a1), 20),
        f"device encode batch{BATCH}": raw_mb * BATCH / sustained(lambda: api.fast_encode(
            tiles_dev.to(torch.int64), zb, zb, HILBERT, (1, 1, 1), True, 8, n_words,
            lanewise=True), 3),
        f"device decode batch{BATCH}": raw_mb * BATCH / sustained(dec_batch, 3),
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

    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": KERNELS[name][0],
         "replaces": KERNELS[name][1], "launches": launches[name],
         "max_abs_err": kres[name][0], "ms": kres[name][1], "plain_ms": kres[name][2]}
        for name in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
