"""Multi-device QB3: block-row strips of one raster over a group of devices.

PyTorch counterpart of qb3_tpu/parallel/sharded.py.  The image is sharded in
block-row-aligned strips, one a device.  The serial band state at a strip
boundary is a function of the previous strip's own data, so it needs no
sequential chain:

  * entry_prev = the previous strip's last scanned (band-decorrelated)
    value, exchanged with one ppermute;
  * entry_runbits = the rung of the previous strip's last block, one more
    ppermute (a strip's exit rung does not depend on its entry rung);
  * in the best modes, the entry pcf = the last CF set among the earlier
    strips, from one all-gather.

Each device then runs the ordinary phase A and pack (K1) on its strip; the
fast modes stitch inside the shard (stitch.scatter_stitch_shard) and
assemble on the host, the best modes stitch on the first device (K6).  The
payload is the single-device stream's byte for byte (encode_sharded frames
it as qb3_tpu's does, framing.py).  The decode shards the
same way from an "ix", "ib" or "ic" sidecar: each device gets only the word
window of its own strip, and the rung and prev chains cross the shards
through all-gathered per-shard totals.

qb3_tpu runs its shard functions under shard_map over a Mesh of
jax.devices() in one process.  Here a ShardGroup runs them, one Python
thread a shard, each under its device, with the collectives qb3_tpu takes
from jax.lax.  ``devices`` names the shards' devices: None is one CUDA
device a shard (cuda:0 .. cuda:n-1), ["cuda:0"] * n puts n shards on one
card (the counterpart of qb3_tpu's --xla_force_host_platform_device_count
CPU mesh) and ["cpu"] * n runs the kernels' plain twins on the CPU.
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

from .. import _build, container, framing
from ..api import (DT_FROM_NP, NP_FROM_DT, UNSIGNED, _parse_best_sidecar, default_cband,
                   from_carrier, group_inputs, max_encoded_size, quantize, stream_words,
                   to_carrier)
from ..constants import (B, B2, HILBERT, ZCURVE, DType, Mode, is_best_mode, mode_uses_zcurve,
                         ubits_for)
from ..errors import QB3ShapeError
from ..offsets import KIND_BITS, KIND_NORMAL, KIND_ZERO
from ..ops.bitpack import group_bits_bound, pack_groups_auto, words_to_bytes
from ..ops.bitutils import peek64, smag, srl, wrap
from ..ops.chunkwalk_cuda import ic_walk_params
from ..ops.decode import _NREG_IX, K5_KIND, decode_groups, dsw_arith, payload_words, reconstruct
from ..ops.decode_chunked import decode_chunked_auto, parse_ic
from ..ops.encode import block_rungs, delta_mags, fast_symbols, gather_blocks
from ..ops.encode_best import encode_best_blocks
from ..ops.gather_cuda import GATHER_MAX_R, gather_span
from ..stitch import assemble_scatter, scatter_stitch_shard, stitch_words_device

BARRIER_TIMEOUT_S = 600.0  # longest a shard waits for the others at a collective


def shard_devices(devices, n: int) -> list[torch.device]:
    """The n shards' devices: None -> cuda:0 .. cuda:n-1 (raises with fewer
    CUDA devices, never falls back to the CPU), else the given list, which
    must have n entries."""
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n:
            raise RuntimeError(f"need {n} devices, have {have}; pass devices= to place "
                               "several shards on one device")
        return [torch.device("cuda", i) for i in range(n)]
    devs = [torch.device(d) for d in devices]
    if len(devs) != n:
        raise ValueError(f"{len(devs)} devices for {n} shards")
    return devs


class ShardGroup:
    """SPMD shards over a list of devices, as shard_map runs them: run()
    calls a shard function once a device, one Python thread a shard, each
    under torch.cuda.device of its device; inside it the function reaches
    the group's collectives, which jax.lax gives qb3_tpu's.  A collective
    writes each shard's tensor to its slot, waits on a barrier for all of
    them, takes what the shard needs, and waits again before the slots are
    used anew.  Every shard stays on its device's current (default) stream,
    so work on one device runs in the order the barrier gives; a copy to
    another device orders against both devices' streams.

    ShardGroup.bytes_moved counts the bytes the shards of every group
    received from each other in collectives (as a kernel wrapper's
    ``launches`` counts launches: callers set it to 0 and read it)."""

    bytes_moved = 0
    _count_lock = threading.Lock()

    def __init__(self, devices, timeout: float = BARRIER_TIMEOUT_S):
        self.devices = [torch.device(d) for d in devices]
        self.timeout = timeout
        self._local = threading.local()
        self._slots = [None] * len(self.devices)
        self._barrier = threading.Barrier(len(self.devices), timeout=timeout)

    def axis_index(self) -> int:
        """The calling shard's index (jax.lax.axis_index)."""
        return self._local.index

    def axis_size(self) -> int:
        """The number of shards (jax.lax.axis_size)."""
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """The calling shard's device."""
        return self.devices[self.axis_index()]

    @classmethod
    def _moved(cls, nbytes: int):
        with cls._count_lock:
            cls.bytes_moved += nbytes

    def _exchange(self, x) -> list:
        """Every shard's x, in shard order."""
        self._slots[self.axis_index()] = x
        self._barrier.wait()
        parts = list(self._slots)
        self._barrier.wait()
        return parts

    def all_gather(self, x):
        """(n, ...) tensor of every shard's x on the calling shard's device,
        in shard order (jax.lax.all_gather)."""
        parts = self._exchange(x)
        i = self.axis_index()
        self._moved(sum(p.nbytes for k, p in enumerate(parts) if k != i))
        return torch.stack([p.to(self.device) for p in parts])

    def ppermute_next(self, x):
        """Shard i receives shard i - 1's x; shard 0 receives zeros, as
        jax.lax.ppermute gives a device that receives nothing."""
        parts = self._exchange(x)
        i = self.axis_index()
        if i == 0:
            return torch.zeros_like(x)
        self._moved(parts[i - 1].nbytes)
        return parts[i - 1].to(self.device, copy=True)

    def run(self, fn, *per_shard) -> list:
        """fn(*args) on every shard, args the shard's entries of the lists
        in per_shard -> the shards' results in order.  The kernel library
        is loaded first, so no two shards build it.  A shard that raises
        aborts the barrier, so the others raise BrokenBarrierError at their
        next collective instead of waiting; every thread is joined, then
        the first exception that is not a BrokenBarrierError raises here
        (a barrier that timed out raises its BrokenBarrierError)."""
        n = len(self.devices)
        if any(d.type == "cuda" for d in self.devices):
            _build.load()
        self._barrier = threading.Barrier(n, timeout=self.timeout)
        results, errors = [None] * n, [None] * n

        def body(i):
            self._local.index = i
            dev = self.devices[i]
            try:
                with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
                    results[i] = fn(*(a[i] for a in per_shard))
            except BaseException as e:  # noqa: BLE001 -- re-raised in the caller
                errors[i] = e
                self._barrier.abort()

        threads = [threading.Thread(target=body, args=(i,), name=f"qb3 shard {i}", daemon=True)
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        self._slots = [None] * n
        failed = [e for e in errors if e is not None]
        if failed:
            raise next((e for e in failed if not isinstance(e, threading.BrokenBarrierError)),
                       failed[0])
        return results


# ------------------------------------------------------------------ encode

def _shard_encode_fn(group, order, cband, skipstep, tbits, n_words):
    """The fast modes' phase A and pack of one strip, or with a leading tile
    axis of each tile's row part: the strip's entry prev and rung arrive
    from the previous shard by ppermute (zero at shard 0).  Returns (words,
    total, glen, rung)."""
    ubits = ubits_for(tbits // 8)
    maxbits = group_bits_bound(tbits, best=False)

    def fn(img_local):
        vals = gather_blocks(img_local, order, cband, tbits)
        entry_prev = group.ppermute_next(vals[..., -1, :, -1])
        m, _ = delta_mags(vals, entry_prev, tbits)
        bitsused, rung, _, exit_runbits = block_rungs(m, torch.zeros_like(entry_prev))
        entry_runbits = group.ppermute_next(exit_runbits)
        oldrung = torch.cat([entry_runbits[..., None, :], rung[..., :-1, :]], dim=-2)
        codes, lens = fast_symbols(m, bitsused, rung, oldrung, ubits, skipstep, tbits)
        *lead, nblocks, nb, nsym = codes.shape
        words, total, glen = pack_groups_auto(
            codes.reshape(*lead, nblocks * nb, nsym),
            lens.reshape(*lead, nblocks * nb, nsym).to(torch.int32), n_words, maxbits)
        return words, total, glen, rung

    return fn


def _shard_best_fn(group, order, cband, tbits, n_words):
    """The best modes' phase A (encode_best_blocks with its three hooks on
    the group) and pack of one strip.  Returns (words, total, glen, meta16,
    cfv)."""
    maxbits = group_bits_bound(tbits, best=True)

    def fn(img_local):
        n, my = group.axis_size(), group.axis_index()
        dev = img_local.device

        def prev_exchange(vals):
            return group.ppermute_next(vals[-1, :, -1])

        def rung_exchange(exit_runbits):
            return group.ppermute_next(exit_runbits)

        def cf_exchange(is_set, set_val):
            # entry pcf = the last CF set among the shards before me (else
            # 0): each shard's last set CF, all-gathered, "last set wins"
            idx = torch.where(is_set, torch.arange(is_set.shape[0], device=dev)[:, None], -1)
            last = idx.amax(0)  # (C,)
            val = set_val.gather(0, last.clamp(min=0)[None])[0]
            all_has = group.all_gather(last >= 0)  # (n, C)
            all_val = group.all_gather(val)
            shard = torch.arange(n, device=dev)[:, None]
            sidx = torch.where(all_has & (shard < my), shard, -1).amax(0)
            ent = all_val.gather(0, sidx.clamp(min=0)[None])[0]
            return torch.where(sidx >= 0, ent, 0)

        z = torch.zeros(img_local.shape[-1], dtype=torch.int64, device=dev)
        codes, lens, _, _, _, meta16, cfv, _, _ = encode_best_blocks(
            img_local, z, z, z, order, cband, tbits, cf_exchange=cf_exchange,
            prev_exchange=prev_exchange, rung_exchange=rung_exchange)
        words, total, glen = pack_groups_auto(codes, lens, n_words, maxbits)
        return words, total, glen, meta16, cfv

    return fn


def _host(t) -> np.ndarray:
    return t.cpu().numpy()


def _encode_sharded_payload(img, n_dev, order, cband, skipstep, best, devices):
    """Phase A and pack of every strip, then the stitch -> (payload bytes,
    per-shard bit totals, the sidecar's pieces for framing.sidecar): glen
    and rung in the fast modes, glen, meta16 and cfv in the best modes,
    each concatenated in stream order."""
    h, w, nb = img.shape
    if h % (B * n_dev) != 0:
        raise QB3ShapeError("height must split into whole block rows per device")
    if cband is None:
        cband = tuple(range(nb))
    group = ShardGroup(shard_devices(devices, n_dev))
    tbits = 8 * img.dtype.itemsize
    n_words = stream_words(w, h // n_dev, nb, DT_FROM_NP[img.dtype])
    if best:
        fn = _shard_best_fn(group, order, tuple(cband), tbits, n_words)
    else:
        base = _shard_encode_fn(group, order, tuple(cband), skipstep, tbits, n_words)

        def fn(x):
            words, total, glen, rung = base(x)
            own, n_own, nbits = scatter_stitch_shard(words, total, group)
            return own, n_own, nbits, glen, rung

    # the strips go to their devices before the shards start, as qb3_tpu
    # device_puts the image before its shard_map: an upload from pageable
    # memory waits for the work queued ahead of it on the device
    parts = [to_carrier(p, d) for p, d in zip(np.split(img, n_dev), group.devices)]
    outs = group.run(fn, parts)
    if best:
        dev0 = group.devices[0]
        totals = np.array([int(o[1]) for o in outs], np.int64)
        total = int(totals.sum())
        stitched, total = stitch_words_device([o[0].to(dev0) for o in outs], totals,
                                              (total + 31) // 32)
        payload = words_to_bytes(_host(stitched).view(np.uint32), total)
        pieces = {k: np.concatenate([_host(o[i]) for o in outs])
                  for k, i in (("glen", 2), ("meta16", 3), ("cfv", 4))}
    else:
        totals = np.array([int(o[2]) for o in outs], np.int64)
        n_owns = [int(o[1]) for o in outs]
        owns = [_host(o[0][:n + 1]).view(np.uint64) for o, n in zip(outs, n_owns)]
        payload = assemble_scatter(owns, n_owns, totals)
        pieces = {"glen": np.concatenate([_host(o[3]) for o in outs]),
                  "rung": np.concatenate([_host(o[4]) for o in outs]).reshape(-1, nb)}
    return payload, totals, pieces


def encode_fast_sharded_scatter(img: np.ndarray, n_dev: int, order: int = HILBERT,
                                cband: tuple[int, ...] | None = None,
                                skipstep: bool = True, devices=None):
    """encode_fast_sharded with the reduce-scatter-style stitch: every shard
    keeps only its own word span of the final stream and the host
    concatenates at word granularity.  The stitch's traffic between shards
    is the all-gather of the bit totals (8 bytes a shard).  Byte-exact with
    the single-device stream.  The port's encode_fast_sharded stitches this
    way too (as qb3_tpu's does since its in-shard stitch), so the two
    return the same."""
    return encode_fast_sharded(img, n_dev, order, cband, skipstep, devices)


def encode_fast_sharded(img: np.ndarray, n_dev: int, order: int = HILBERT,
                        cband: tuple[int, ...] | None = None, skipstep: bool = True,
                        devices=None):
    """Encode (H, W, C) across n_dev shards; H must be a multiple of
    4 * n_dev.  Returns (payload bytes, per-shard bit lengths), byte-exact
    with the single-device stream.  encode_sharded() adds container
    framing."""
    payload, totals, _ = _encode_sharded_payload(img, n_dev, order, cband, skipstep, False,
                                                 devices)
    return payload, totals


def encode_sharded(img: np.ndarray, n_dev: int, mode: int | None = None, quanta: int = 1,
                   away: bool = False, coreband=None, index=False, devices=None) -> bytes:
    """Full container encode over n_dev shards: quanta, RLE post-pass,
    stored fallback, core bands, and the ix / ic / ib sidecars.  The payload
    is the single-device Encoder's bit for bit; the framing follows
    qb3_tpu's encode_sharded, which differs from its Encoder twice: a best
    mode writes the "ib" sidecar for any true ``index``, "ic" included, and
    an RLE mode whose post-pass is not taken stores the raster where the
    coded stream is not smaller than it (framing.py)."""
    h, w, nb = img.shape
    dtype = DT_FROM_NP[img.dtype]
    user_mode = Mode(mode if mode is not None else Mode.FTL)
    mode = framing.RLE_BASE.get(user_mode, user_mode)
    order = ZCURVE if mode_uses_zcurve(user_mode) else 0
    cband = tuple(coreband) if coreband is not None else tuple(default_cband(nb))

    work = img
    if quanta >= 2:
        work = quantize(work, quanta, away)
    uns = work.view(UNSIGNED[work.dtype.itemsize])

    payload, _, pieces = _encode_sharded_payload(
        uns, n_dev, order or HILBERT, cband, mode == Mode.FTL, is_best_mode(mode), devices)
    frame = framing.Frame(w, h, nb, dtype, list(cband), quanta, order)
    # store_rle: qb3_tpu/parallel/sharded.py:305-308 stores after an RLE mode too
    return frame.finish(user_mode, payload, framing.sidecar(index, **pieces),
                        max_encoded_size(w, h, nb, dtype), raw=img, store_rle=True)


def encode_tiles_sharded(tiles: np.ndarray, n_batch: int, n_rows: int,
                         order: int = HILBERT, cband: tuple[int, ...] | None = None,
                         skipstep: bool = True, devices=None) -> list[bytes]:
    """2-D mesh variant: an (N, H, W, C) batch over n_batch x n_rows shards
    (qb3_tpu's ("batch", "rows") mesh): tiles data-parallel over n_batch
    groups, each tile's rows over the n_rows shards of its group (fresh
    band state a tile, as batch.encode_tiles); each group stitches its
    tiles' row parts on its first device (K6).  devices: n_batch * n_rows,
    group-major.  Returns one payload a tile, byte-exact with the
    single-device streams."""
    n, h, w, nb = tiles.shape
    devs = shard_devices(devices, n_batch * n_rows)
    if n % n_batch or h % (B * n_rows):
        raise QB3ShapeError("batch/rows must split evenly over the mesh")
    if cband is None:
        cband = tuple(range(nb))
    tbits = 8 * tiles.dtype.itemsize
    n_words = stream_words(w, h // n_rows, nb, DT_FROM_NP[tiles.dtype])
    h_l, n_l = h // n_rows, n // n_batch
    parts = [[to_carrier(np.ascontiguousarray(tiles[b * n_l:(b + 1) * n_l, r * h_l:(r + 1) * h_l]),
                         devs[b * n_rows + r]) for r in range(n_rows)] for b in range(n_batch)]

    def batch_shard(b):
        rows = ShardGroup(devs[b * n_rows:(b + 1) * n_rows])
        fn = _shard_encode_fn(rows, order, tuple(cband), skipstep, tbits, n_words)
        outs = rows.run(lambda part: fn(part)[:2], parts[b])
        dev0 = rows.devices[0]
        words = [o[0].to(dev0) for o in outs]  # each (n_l, n_words)
        totals = np.stack([_host(o[1]) for o in outs], axis=1)  # (n_l, n_rows)
        out = []
        for t in range(n_l):
            total = int(totals[t].sum())
            stitched, total = stitch_words_device([wr[t] for wr in words], totals[t],
                                                  (total + 31) // 32)
            out.append(words_to_bytes(_host(stitched).view(np.uint32), total))
        return out

    groups = ShardGroup([devs[b * n_rows] for b in range(n_batch)])
    return [s for part in groups.run(batch_shard, list(range(n_batch))) for s in part]


# ------------------------------------------------------------------ decode

def _finish_shard(group, g, nblocks_l, nbands, h_l, w, order, cband, tbits):
    """Shared decode tail: the prev chain across shards (all-gathered
    per-shard value totals, mod 2^tbits), then the strip's reconstruct ->
    (h_l, W, C) int64 carrier."""
    my, n = group.axis_index(), group.axis_size()
    g = g.reshape(nblocks_l, nbands, B2)
    all_v = group.all_gather(smag(g, tbits).sum(dim=(0, 2)))  # (n, C); int64 sums wrap
    prior = torch.arange(n, device=g.device)[:, None] < my
    entry_prev = wrap(torch.where(prior, all_v, 0).sum(0), tbits)
    img, _ = reconstruct(g, entry_prev, h_l, w, nbands, order, cband, tbits)
    return img


def _shard_decode_fn(group, order, cband, apply_step, tbits, nblocks_l, nbands, h_l, w, R):
    """"ix" shard decode over the shard's own payload window: the
    all-gathered bit totals give the strip's start, the all-gathered
    codeswitch delta sums its entry rung; then K7 gathers each group's
    window and K5 walks it."""
    ubits = ubits_for(tbits // 8)
    nmask = (1 << ubits) - 1
    nreg = _NREG_IX[tbits]

    def fn(win64, glens_l, winbase):
        my, n = group.axis_index(), group.axis_size()
        dev = win64.device
        shard = torch.arange(n, device=dev)
        all_bits = group.all_gather(glens_l.sum())
        rel0 = torch.where(shard < my, all_bits, 0).sum() - winbase  # window-relative start
        goff = (torch.cumsum(glens_l, 0) - glens_l + rel0).reshape(nblocks_l, nbands)
        wv = peek64(win64, goff)
        has_cs = (wv & 1) == 1
        dlen, ddelta = dsw_arith(srl(wv, 1), ubits)
        cs_len = torch.where(has_cs, dlen, 1)
        delta = torch.where(has_cs, ddelta, 0)
        # the rung chain: local prefix sum + the earlier shards' delta sums
        all_dsum = group.all_gather(delta.sum(0))  # (n, C)
        entry_rung = torch.where(shard[:, None] < my, all_dsum, 0).sum(0)
        rung = (torch.cumsum(delta, 0) + entry_rung) & nmask
        rung0 = rung == 0
        flag = peek64(win64, goff + cs_len) & 1
        kind = torch.where(rung0, torch.where(flag == 1, int(K5_KIND[KIND_BITS]),
                                              int(K5_KIND[KIND_ZERO])),
                           int(K5_KIND[KIND_NORMAL]))
        val_pos = (goff + cs_len + rung0.to(torch.int64)).reshape(-1)
        n32 = 2 * win64.shape[0]
        g = decode_groups(win64.view(torch.int32), (val_pos >> 5).clamp(max=n32).to(torch.int32),
                          (val_pos & 31).to(torch.int32), rung.reshape(-1).to(torch.int32),
                          kind.reshape(-1).to(torch.int32), None, nreg, R, tbits, apply_step)
        return _finish_shard(group, g, nblocks_l, nbands, h_l, w, order, cband, tbits)

    return fn


def _shard_decode_best_fn(group, order, cband, tbits, nblocks_l, nbands, h_l, w):
    """"ib" shard decode: the groups' kind, value position (relative to the
    shard's window), rung and CF come from the host's sidecar parse, then
    K7 + K5."""

    def fn(words32, inp):
        g = decode_groups(words32, **inp, tbits=tbits, apply_step=True)
        return _finish_shard(group, g, nblocks_l, nbands, h_l, w, order, cband, tbits)

    return fn


def _shard_decode_chunked_fn(group, order, cband, apply_step, tbits, k_blocks, nblocks_l,
                             nbands, h_l, w, ncl):
    """"ic" shard decode: each shard walks the ncl chunks that COVER its
    strip (chunk anchors need not align with shard boundaries: the strip's
    first blocks may sit mid-chunk; K3 + K2 for u8/u16) and slices its own
    nblocks_l blocks out of the decoded range from blkoff."""

    def fn(words32, starts_l, entry_l, blkoff, maxw, R):
        g = decode_chunked_auto(words32, starts_l, entry_l, k_blocks, ncl * k_blocks, nbands,
                                apply_step, tbits, maxw, R)
        g = g.reshape(ncl * k_blocks, nbands, B2)[blkoff:blkoff + nblocks_l]
        return _finish_shard(group, g, nblocks_l, nbands, h_l, w, order, cband, tbits)

    return fn


def _shard_windows(words: np.ndarray, start_bits: np.ndarray, end_bits: np.ndarray,
                   slack64: int):
    """Per-shard payload windows: (n_dev, WS) u64 + absolute bit bases."""
    n_dev = len(start_bits)
    base_w = (start_bits >> 6).astype(np.int64)
    end_w = (end_bits >> 6).astype(np.int64) + slack64
    WS = int((end_w - base_w).max()) + 2
    win = np.zeros((n_dev, WS), np.uint64)
    for s in range(n_dev):
        src = words[base_w[s]: min(base_w[s] + WS, len(words))]
        win[s, : len(src)] = src
    return win, base_w * 64


def _ix_span(goff: np.ndarray, tbits: int, n32: int) -> int:
    """K7's staged span R for an "ix" shard from its groups' window-relative
    start bits (host side): a group's first value bit lies at most ubits + 3
    bits past its start (codeswitch and all-zero flag), so its window word
    is at most one past (goff + ubits + 3) >> 5's predecessor, and the span
    of those words plus 4 covers the true one."""
    ub = np.minimum((goff + ubits_for(tbits // 8) + 3) >> 5, n32)
    return min(gather_span(ub, _NREG_IX[tbits]) + 4, GATHER_MAX_R)


def decode_fast_sharded(stream: bytes, n_dev: int, devices=None) -> np.ndarray:
    """Decode a sidecar-indexed stream with the image sharded over n_dev
    shards (block-row strips).  All three sidecars: "ix" (FTL/BASE
    per-group lengths), "ib" (best-mode metadata), "ic" (chunk anchors).
    Each shard receives only the payload word window covering its own strip
    (plus register slack), and the rung / prev chains cross shard
    boundaries through all-gathered per-shard totals."""
    info = container.parse_headers(stream)
    h, w, nb = info.ysize, info.xsize, info.nbands
    if h % (B * n_dev) != 0 or w % B != 0:
        raise QB3ShapeError("image shape must split into whole block rows per device")
    group = ShardGroup(shard_devices(devices, n_dev))
    np_dt = NP_FROM_DT[DType(info.dtype)]
    size = np.dtype(np_dt).itemsize
    tbits = 8 * size
    words = payload_words(stream[info.data_offset:])
    nblocks = (h // B) * (w // B)
    nblocks_l = nblocks // n_dev
    gpd = nblocks_l * nb  # groups per shard
    h_l = h // n_dev
    order, cband = info.order or HILBERT, tuple(info.cband)
    slack = _NREG_IX[tbits] // 2 + 2
    shards = list(range(n_dev))

    def put(arr, s):
        """A shard's input on its device, uploaded before the shards start."""
        return torch.from_numpy(np.ascontiguousarray(arr)).to(group.devices[s])

    def finish(imgs) -> np.ndarray:
        return np.concatenate([from_carrier(x, size) for x in imgs]).view(np_dt)

    if info.index_best is not None and is_best_mode(Mode(info.mode)):
        meta = _parse_best_sidecar(info.index_best, nblocks * nb)
        if meta is None:
            raise QB3ShapeError("oversized CF in ib sidecar")
        val_pos = meta["val_pos"].reshape(n_dev, gpd)
        start_bits = np.maximum(val_pos[:, 0] - 64, 0)  # the codeswitch bits come first
        end_bits = np.concatenate([start_bits[1:], [len(words) * 64 - slack * 64]])
        win, winbase = _shard_windows(words, start_bits, end_bits, slack)
        inps = [group_inputs({"kind": meta["kind"].reshape(n_dev, gpd)[s],
                              "val_pos": val_pos[s] - winbase[s],
                              "vrung": meta["vrung"].reshape(n_dev, gpd)[s],
                              "cf": meta["cf"].reshape(n_dev, gpd)[s]},
                             2 * win.shape[1], tbits, group.devices[s]) for s in shards]
        fn = _shard_decode_best_fn(group, order, cband, tbits, nblocks_l, nb, h_l, w)
        return finish(group.run(fn, [put(win[s].view(np.int32), s) for s in shards], inps))

    if info.index_chunked is not None:
        parsed = parse_ic(info.index_chunked, nblocks, nb)
        if parsed is None:
            raise QB3ShapeError("inconsistent ic sidecar")
        k, starts, entry, tot = parsed
        nchunks = len(starts)
        # shard s covers chunks [c0, c1): the head blocks of a straddling
        # chunk are decoded too and sliced off in the shard (blkoff)
        sidx = np.arange(n_dev, dtype=np.int64)
        c0 = (sidx * nblocks_l) // k
        c1 = -(-((sidx + 1) * nblocks_l) // k)
        ncl = int((c1 - c0).max())
        idx = np.minimum(c0[:, None] + np.arange(ncl)[None, :], nchunks - 1)
        blkoff = sidx * nblocks_l - c0 * k
        # the window runs through the shard's LAST chunk (which may reach
        # into the next strip), to the next anchor after c1 - 1
        end_bits = np.where(c1 < nchunks, starts[np.minimum(c1, nchunks - 1)], tot)
        win, winbase = _shard_windows(words, starts[idx[:, 0]], end_bits, slack)
        lstarts = starts[idx] - winbase[:, None]
        spans = np.diff(np.append(starts, tot))[idx]
        # the u8/u16 walk's window sizes from each shard's own local starts
        params = [ic_walk_params(lstarts[s], spans[s]) if tbits <= 16 else (None, None)
                  for s in shards]
        fn = _shard_decode_chunked_fn(group, order, cband, info.mode != Mode.FTL, tbits, k,
                                      nblocks_l, nb, h_l, w, ncl)
        return finish(group.run(
            fn, [put(win[s].view(np.int32), s) for s in shards],
            [put(lstarts[s].astype(np.int32), s) for s in shards],
            [put(entry[idx[s]], s) for s in shards], [int(b) for b in blkoff],
            [p[0] for p in params], [p[1] for p in params]))

    if info.index is None or info.mode not in (Mode.FTL, Mode.BASE_H, Mode.BASE_Z):
        raise QB3ShapeError("sharded decode needs an ix/ib/ic-indexed stream")
    glens = np.frombuffer(info.index, dtype="<u2").astype(np.int64)
    bits = np.cumsum(glens)
    start_bits = np.concatenate([[0], bits[gpd - 1::gpd][:-1]])
    end_bits = bits[gpd - 1::gpd]
    win, winbase = _shard_windows(words, start_bits, end_bits, slack)
    gl = glens.reshape(n_dev, gpd)
    goff = np.cumsum(gl, axis=1) - gl + (start_bits - winbase)[:, None]  # host copy for K7's R
    R = max(_ix_span(goff[s], tbits, 2 * win.shape[1]) for s in shards)
    fn = _shard_decode_fn(group, order, cband, info.mode != Mode.FTL, tbits, nblocks_l, nb,
                          h_l, w, R)
    return finish(group.run(fn, [put(win[s].view(np.int64), s) for s in shards],
                            [put(gl[s], s) for s in shards], [int(b) for b in winbase]))


def stitch_streams(words: np.ndarray, totals: np.ndarray,
                   devices=None) -> tuple[bytes, np.ndarray]:
    """Concatenate per-shard bitstreams at bit granularity, on the device:
    the parts go to the first of the shards' devices and K6 places them
    (stitch.stitch_words_device); the bytes are qb3_tpu's host stitch's.

    words: (n_shards, n_words) uint32; totals: (n_shards,) bit lengths;
    devices: the n_shards shards' devices (None: cuda:0 .. n_shards - 1).
    """
    dev = shard_devices(devices, words.shape[0])[0]
    parts = torch.from_numpy(np.ascontiguousarray(words, np.uint32).view(np.int32)).to(dev)
    total = int(np.sum(totals))
    stitched, total = stitch_words_device(list(parts), [int(t) for t in totals],
                                          (total + 31) // 32)
    return words_to_bytes(_host(stitched).view(np.uint32), total), totals


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """The sharded paths on tiny shapes, as qb3_tpu's
    __graft_entry__.dryrun_multichip runs them: framed FTL / CF_H / RLE_H
    streams, u64 and quanta, the ix / ib / ic sharded decodes, the scatter
    stitch and the 2-D mesh, each checked against the port's single-device
    encode and decode on the first shard's device."""
    from .. import api, batch

    devs = shard_devices(devices, n_devices)
    one = devs[0]
    h, w, nb = 8 * n_devices, 16, 3
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([(x * 3 + y * 5 + c * 7) % 199 for c in range(nb)],
                   axis=-1).astype(np.uint8)  # smooth, compressible raster

    sizes = {}
    for mode in (Mode.FTL, Mode.CF_H, Mode.RLE_H):
        index = "ic" if mode == Mode.FTL else False
        stream = encode_sharded(img, n_devices, mode=mode, index=index, devices=devs)
        assert stream == api.encode(img, mode=mode, index=index, device=one), \
            f"sharded {mode.name} stream mismatch"
        assert (api.decode(stream, device=one)[0] == img).all(), \
            f"sharded {mode.name} decode mismatch"
        sizes[mode.name] = len(stream)

    # u64 high-rung data + lossy quanta, byte-exact with single-device
    img64 = img.astype(np.uint64) * np.uint64(1 << 40)
    s64 = encode_sharded(img64, n_devices, mode=Mode.FTL, index=True, devices=devs)
    assert s64 == api.encode(img64, mode=Mode.FTL, index=True, device=one), "u64"
    sq = encode_sharded(img, n_devices, mode=Mode.BASE_H, quanta=4, devices=devs)
    assert sq == api.encode(img, mode=Mode.BASE_H, quanta=4, device=one), "quanta"
    dq, _ = api.decode(sq, device=one)
    assert (np.abs(dq.astype(int) - img.astype(int)) <= 2).all(), "quanta dec"

    # sharded DECODE round trips on all three sidecars (ix / ib / ic)
    wide = np.ascontiguousarray(np.tile(img, (1, 8, 1)))  # ic needs W/4 % 8 == 0
    for mode, index, name in ((Mode.FTL, True, "ix"), (Mode.CF_H, True, "ib"),
                              (Mode.FTL, "ic", "ic")):
        s = api.encode(wide, mode=mode, index=index, device=one)
        assert (decode_fast_sharded(s, n_devices, devices=devs) == wide).all(), \
            f"{name} sharded dec"

    # the scatter stitch
    p1, _ = encode_fast_sharded(img, n_devices, devices=devs)
    p2, _ = encode_fast_sharded_scatter(img, n_devices, devices=devs)
    assert p1 == p2, "scatter stitch mismatch"

    # 2-D (batch x rows) mesh, byte-exact a tile
    if n_devices >= 4 and n_devices % 2 == 0:
        nb2, nr2 = n_devices // 2, 2
        tiles = np.stack([np.roll(img[: 8 * nr2], i, axis=0) for i in range(nb2 * 3)])
        outs = encode_tiles_sharded(tiles, nb2, nr2, devices=devs)
        singles = batch.encode_tiles(tiles, mode=Mode.FTL, coreband=tuple(range(nb)),
                                     device=one)
        hdr = len(container.write_headers(w, 8 * nr2, nb, 0, Mode.FTL, list(range(nb)), 1, 0))
        for i, o in enumerate(outs):
            assert o == singles[i][hdr:], f"2-D mesh tile {i}"

    print(f"dryrun_multichip({n_devices}): framed streams byte-exact with "
          f"single-device and decodable — sizes {sizes}; u64/quanta ok; "
          f"sharded ix/ib/ic decode ok; scatter stitch ok; 2-D mesh ok")
