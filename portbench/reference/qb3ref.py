"""Plain NumPy QB3: the benchmark's reference encoder and decoder.

Written from the stream format (lucianpls/QB3, doc/QB3.md and the
encoder it describes) for what the benchmark's configurations run: 8- and
16-bit rasters, unsigned or signed, whose sides are multiples of 4; FTL and
BASE_H with no sidecar or the "ic" chunk sidecar, CF_H without one, and
their RLE0 forms RLE_H and CF_RLE_H; lossless or quantized by a step
`quanta` (the "QV" chunk).  It imports NumPy alone and nothing of the
program under test.  The encoder is vectorised over the groups of a slice
of block rows (a group is one band of one 4x4 block, 16 values) and carries
each band's state from slice to slice, so that a scene of any height takes
a bounded amount of memory; the decoder is a serial walk over the bits, one
group after another, as the format is defined.

    stream = encode(img, FTL, index="ic")            # bytes
    stream = encode(dem, MODES["CF_RLE_H"], quanta=4)
    img = decode(stream)                              # (H, W, C) array
"""

from __future__ import annotations

import struct

import numpy as np

B, B2 = 4, 16
HILBERT = 0x01548CD9AEFB7623
ZCURVE = 0x0145236789CDABEF
BASE_H, CF_H, RLE_H, CF_RLE_H, FTL, STORED = 4, 5, 6, 7, 8, 255
# a configuration's "mode" -> the mode's number in the header
MODES = {"FTL": FTL, "BASE_H": BASE_H, "CF_H": CF_H, "RLE_H": RLE_H, "CF_RLE_H": CF_RLE_H}
RLE_BASE = {RLE_H: BASE_H, CF_RLE_H: CF_H}  # an RLE0 mode's coding mode
# the header's type codes (QB3.h:40): a signed raster is coded as its
# unsigned bit pattern, and only the header says it is signed
NP_DTYPES = {0: np.uint8, 1: np.int8, 2: np.uint16, 3: np.int16}
DTYPES = {np.dtype(t): code for code, t in NP_DTYPES.items()}
UNSIGNED = {1: np.uint8, 2: np.uint16}
SLICE_GROUPS = 1 << 16  # groups the encoder vectorises over at once, at most
IC_K = 8  # blocks a chunk of the "ic" sidecar
_IC_WIDE = 0x8000
_LANES = np.arange(B2)


# ------------------------------------------------------------------ codes

def ubits(tbits: int) -> int:
    """Bits of the rung field (codeswitch width) of a type."""
    return {8: 3, 16: 4}[tbits]


def default_cband(nbands: int) -> list[int]:
    """The core band of each band: R-G, G, B-G for 3 or 4 bands."""
    cb = list(range(nbands))
    if nbands in (3, 4):
        cb[0] = cb[2] = 1
    return cb


def curve_lanes(order: int) -> np.ndarray:
    """In-block raster index (dy * 4 + dx) of each of the 16 curve
    positions, most significant nibble first."""
    return np.array([(order >> (4 * (15 - i))) & 0xF for i in range(B2)], np.int64)


def topbit(v):
    """floor(log2(v)) of positive integers (exact below 2^53)."""
    return np.frexp(np.asarray(v, np.float64))[1].astype(np.int64) - 1


def vlc(v, r):
    """The three-range code of v at rung r >= 1 -> (code, len): v < 2^(r-1)
    in r bits, v < 2^r in r + 1, v < 2^(r+1) in r + 2; bits go LSB first."""
    v, r = np.asarray(v, np.int64), np.asarray(r, np.int64)
    half = np.left_shift(1, r - 1)
    short, nominal = v < half, v < 2 * half
    code = np.where(short, v << 1, np.where(nominal, ((v - half) << 2) | 1,
                                            ((v - 2 * half) << 2) | 3))
    return code, np.where(short, r, np.where(nominal, r + 1, r + 2))


def _swap(v, r, group: bool):
    """The middle swaps: rungs 3-7 exchange 2^r - 1 and 2^r; in a group's
    context rung 1 also exchanges 1 and 2, rung 2 exchanges 3 and 4."""
    a = np.left_shift(1, np.clip(r, 0, 7)) - 1
    on = (r >= 3) & (r <= 7)
    if group:
        a = np.where(r == 1, 1, np.where(r == 2, 3, a))
        on = on | (r == 1) | (r == 2)
    return np.where(on & (v == a), a + 1, np.where(on & (v == a + 1), a, v))


def group_code(v, r):
    """A value's code inside a group at rung r >= 1."""
    return vlc(_swap(v, r, True), r)


def single_code(v, r):
    """A lone value's code (a common factor, an index, a unique value) at
    rung r >= 0; rung 0 is one literal bit."""
    v, r = np.asarray(v, np.int64), np.asarray(r, np.int64)
    code, ln = vlc(_swap(v, r, False), np.maximum(r, 1))
    return np.where(r == 0, v & 1, code), np.where(r == 0, 1, ln)


def _mags8(v: int) -> int:
    v &= 0xFF
    return 0xFF & ((0xFF * (v >> 7)) ^ (v << 1))


def _csw_table(u: int):
    """Codeswitch (code, len) of each rung delta on u bits: delta 0 is one
    0 bit, any other a 1 bit then the mag-sign of the delta, biased so that
    zero stays free, at rung u - 1; and the SIGNAL code, the unused long
    form of "no change", which opens a common-factor or index group."""
    sbit = 1 << (u - 1)

    def biased(d):
        return _mags8(d - 2 * sbit) if d & sbit else _mags8((d - 1) & (sbit - 1))

    def coded(msv):
        c, n = vlc(msv, u - 1)
        return (int(c) << 1) | 1, int(n) + 1

    table = [(0, 1)] + [coded(biased(d)) for d in range(1, 1 << u)]
    return np.array(table, np.int64), coded(biased(0))


CSW = {u: _csw_table(u) for u in (3, 4)}


def codeswitch(delta, u: int, signal: bool = False):
    """(code, len) of rung deltas; with signal, delta 0 takes the SIGNAL."""
    table, sig = CSW[u]
    d = np.asarray(delta, np.int64) & ((1 << u) - 1)
    code, ln = table[d, 0], table[d, 1]
    if signal:
        code, ln = np.where(d == 0, sig[0], code), np.where(d == 0, sig[1], ln)
    return code, ln


# ------------------------------------------------------------------ encode

def mags(d, tbits: int):
    """Two's complement t-bit values -> mag-sign (sign in bit 0)."""
    mask = (1 << tbits) - 1
    return ((d << 1) ^ -((d >> (tbits - 1)) & 1)) & mask


def smags(m, tbits: int):
    """Mag-sign -> two's complement t-bit values."""
    return ((m >> 1) ^ -(m & 1)) & ((1 << tbits) - 1)


def groups_of(img: np.ndarray, cband, order: int = HILBERT, prev=None):
    """(H, W, C) unsigned raster -> (nblocks, C, 16) mag-sign values along
    the curve, and each band's last value: blocks row-major, each dependent
    band less its core band, each band's values less the one before along
    the whole scan (prev before the first: the last value of the block rows
    above, 0 at the top)."""
    h, w, nb = img.shape
    tbits = 8 * img.dtype.itemsize
    mask = (1 << tbits) - 1
    t = img.astype(np.int64).reshape(h // B, B, w // B, B, nb).transpose(0, 2, 4, 1, 3)
    vals = t.reshape(-1, nb, B2)[..., curve_lanes(order)]
    dep = [c for c in range(nb) if cband[c] != c]
    vals[:, dep] = (vals[:, dep] - vals[:, [cband[c] for c in dep]]) & mask
    seq = vals.transpose(1, 0, 2).reshape(nb, -1)
    first = np.zeros(nb, np.int64) if prev is None else prev
    before = np.concatenate([first[:, None], seq[:, :-1]], axis=1)
    m = mags((seq - before) & mask, tbits)
    return m.reshape(nb, -1, B2).transpose(1, 0, 2), seq[:, -1]


def step_flip(m, rung):
    """The step encoding: where the rung bits of a group's values read
    1...10...0 along the curve (k ones, k >= 1), value k - 1 drops its rung
    bit.  m (..., 16), rung (...) >= 1 where it applies."""
    acc = (((m >> rung[..., None]) & 1) << _LANES).sum(-1)
    match = (acc & (acc + 1)) == 0
    ones = np.where(acc == 0, 0, topbit(acc | 1) + 1)
    flip = match & (ones > 0) & (rung >= 1)
    hit = flip[..., None] & (_LANES == (ones - 1)[..., None])
    return m ^ (hit.astype(np.int64) << rung[..., None])


def _rungs(m, old0):
    """Each group's used bits, rung, and the rung of the band's group before
    it (old0 before the first)."""
    used = np.bitwise_or.reduce(m, axis=-1)
    rung = topbit(used | 1)
    old = np.concatenate([old0[None], rung[:-1]], axis=0)
    return used, rung, old


def _values(m, rung, step: bool):
    """The 16 value codes of ordinary groups at their rung."""
    if step:
        m = step_flip(m, rung)
    return group_code(m, np.maximum(rung, 1)[..., None])


def fast_symbols(m, step: bool, tbits: int, old0):
    """FTL / BASE groups -> codes, lens (nblocks, C, 17): the codeswitch
    (with the all-zero / all-one-bit flag at rung 0), then 16 values; and
    each group's rung.  old0: each band's rung before the first block."""
    used, rung, old = _rungs(m, old0)
    cs, csl = codeswitch(rung - old, ubits(tbits))
    rung0 = used <= 1
    pc = np.where(rung0, cs | ((used & 1) << csl), cs)
    pl = np.where(rung0, csl + 1, csl)
    vc, vl = _values(m, rung, step)
    vc = np.where(rung0[..., None], m & 1, vc)
    vl = np.where(rung0[..., None], (used == 1)[..., None].astype(np.int64), vl)
    return (np.concatenate([pc[..., None], vc], -1),
            np.concatenate([pl[..., None], vl], -1), rung)


def _index_group(m, rung, old, u: int):
    """The index encoding of every group: SIGNAL, the flagless switch to the
    top rung, the flagless switch to the group's rung, 16 indices at rung 2
    into the (at most 8) distinct values sorted by falling count (first
    seen first among equals), then those values at the group's rung.
    Returns prefix (code, len), indices (codes, lens), uniques (codes,
    lens), total bits and whether the group has at most 8 values."""
    g = m.reshape(-1, B2)
    eq = g[:, :, None] == g[:, None, :]
    first = eq.argmax(-1)
    is_first = first == _LANES
    nuniq = is_first.sum(-1)
    rank = np.cumsum(is_first, -1) - 1
    rows = np.arange(g.shape[0])[:, None]
    slot = np.clip(rank[rows, first], 0, 7)
    counts = (slot[:, :, None] == np.arange(8)).sum(1)
    live = np.arange(8) < np.minimum(nuniq, 8)[:, None]
    order = np.argsort(np.where(live, -counts, 99), axis=-1, kind="stable")
    inv = np.argsort(order, axis=-1)
    ic, il = single_code(inv[rows, slot], 2)
    uniq = np.zeros((g.shape[0], 8), np.int64)
    keep = is_first & (rank < 8)
    r_, c_ = np.nonzero(keep)
    uniq[r_, rank[r_, c_]] = g[r_, c_]
    us = uniq[rows, order]
    uc, ul = single_code(us, np.broadcast_to(rung.reshape(-1, 1), us.shape))
    ls = live[rows, order]
    uc, ul = np.where(ls, uc, 0), np.where(ls, ul, 0)
    nmask = (1 << u) - 1
    _, (sc, sl) = CSW[u]
    c1, l1 = codeswitch(nmask - old, u, signal=True)
    c2, l2 = codeswitch(rung - old, u, signal=True)
    c1, l1, c2, l2 = c1 >> 1, l1 - 1, c2 >> 1, l2 - 1
    pc = sc | (c1 << sl) | (c2 << (sl + l1))
    pl = sl + l1 + l2
    shape = m.shape
    ic, il = ic.reshape(shape), il.reshape(shape)
    uc, ul = uc.reshape(*shape[:-1], 8), ul.reshape(*shape[:-1], 8)
    total = pl + il.sum(-1) + ul.sum(-1)
    return (pc, pl), (ic, il), (uc, ul), total, (nuniq <= 8).reshape(shape[:-1])


def _cf_group(m, old, u: int, tbits: int):
    """The common-factor encoding of every group whose values share a factor
    cf >= 2: SIGNAL, the flagless switch to the rung of the divided values,
    then '0' (cf as the band's last) or '1' and cf - 2, either at that rung
    behind a '0' or behind its own full switch at its own rung less the top
    bit; then the divided values at their rung with the step, or 16 single
    bits at rung 0."""
    mask = (1 << tbits) - 1
    absm = (m >> 1) + (m & 1)
    cf = np.gcd.reduce(absm, axis=-1)
    has = cf >= 2
    cfs = np.where(has, cf, 2)
    div = (((absm // cfs[..., None]) << 1) - (m & 1)) & mask
    trung = topbit(np.bitwise_or.reduce(div, axis=-1) | 1)
    cfm = cfs - 2
    cfrung = topbit(cfm | 1)
    _, (sc, sl) = CSW[u]
    c, n = codeswitch(trung - old, u, signal=True)
    base, blen = sc | ((c >> 1) << sl), sl + n - 1
    at = (trung >= cfrung) & ((trung < cfrung + u) | (cfrung == 0))
    cat, lat = single_code(cfm, trung)
    own_c, own_l = codeswitch(cfrung - trung, u)
    cown, lown = single_code(cfm ^ np.left_shift(1, cfrung), np.maximum(cfrung - 1, 0))
    dc, dl = _values(div, trung, True)
    dc = np.where((trung == 0)[..., None], div & 1, dc)
    dl = np.where((trung == 0)[..., None], 1, dl)
    body = dl.sum(-1)
    return dict(cf=cfm, has=has, trung=trung, base=base, blen=blen,
                l1_diff=np.where(at, blen + 2, blen + 1),
                s1=(np.where(at, 0, own_c), np.where(at, 0, own_l)),
                s2=(np.where(at, cat, cown), np.where(at, lat, lown)),
                body=(dc, dl),
                size_same=blen + 1 + body,
                size_diff=np.where(at, blen + 2, blen + 1) + np.where(at, 0, own_l)
                + np.where(at, lat, lown) + body)


def best_symbols(m, tbits: int, old0, last0):
    """CF / CF_H groups -> codes, lens (nblocks, C, 27): each group takes the
    ordinary, the common-factor or the index encoding, the last where it is
    shorter than the other and the other is long enough to try it (36 + 3u +
    2 rung bits); a band's last factor carries over, so a factor equal to it
    costs one bit.  Also each group's rung and each band's last factor after
    the last block.  old0, last0: each band's rung and last factor before the
    first block."""
    u = ubits(tbits)
    used, rung, old = _rungs(m, old0)
    rung0 = used <= 1
    active = ~rung0
    cs, csl = codeswitch(rung - old, u)
    pvc, pvl = _values(m, rung, True)
    plain = csl + pvl.sum(-1)
    cf = _cf_group(m, old, u, tbits)
    (ipc, ipl), (ivc, ivl), (iuc, iul), isize, ivalid = _index_group(m, rung, old, u)
    thr = 36 + 3 * u + 2 * rung
    try_idx = active & (rung > 3) & ivalid
    has = cf["has"]
    base_same = np.where(has, cf["size_same"], plain)
    base_diff = np.where(has, cf["size_diff"], plain)
    win_same = try_idx & (base_same >= thr) & (isize < base_same)
    win_diff = try_idx & (base_diff >= thr) & (isize < base_diff)
    # the band's last factor: set by each group that writes its factor, and
    # read by the band's next group
    is_set = active & has & ~win_diff
    nblocks, nb = m.shape[:2]
    setter = np.where(is_set, np.arange(nblocks)[:, None], -1)
    np.maximum.accumulate(setter, axis=0, out=setter)
    factors = np.where(setter >= 0, np.take_along_axis(cf["cf"], np.maximum(setter, 0), 0),
                       last0[None])
    pcf = np.concatenate([last0[None], factors[:-1]], axis=0)
    same = pcf == cf["cf"]
    use_cf = active & has
    win = np.where(same, win_same, win_diff)
    diff = use_cf & ~same & ~win
    p1 = np.where(same, cf["base"], cf["base"] | np.left_shift(1, cf["blen"]))
    l1 = np.where(same, cf["blen"] + 1, cf["l1_diff"])
    s0c = np.where(rung0, cs | ((used & 1) << csl),
                   np.where(win, ipc, np.where(use_cf, p1, cs)))
    s0l = np.where(rung0, csl + 1, np.where(win, ipl, np.where(use_cf, l1, csl)))
    s1c, s1l = (np.where(diff, x, 0) for x in cf["s1"])
    s2c, s2l = (np.where(diff, x, 0) for x in cf["s2"])
    r0, wb, cb = rung0[..., None], win[..., None], use_cf[..., None]
    vc = np.where(r0, m & 1, np.where(wb, ivc, np.where(cb, cf["body"][0], pvc)))
    vl = np.where(r0, (used == 1)[..., None].astype(np.int64),
                  np.where(wb, ivl, np.where(cb, cf["body"][1], pvl)))
    uc, ul = np.where(wb, iuc, 0), np.where(wb, iul, 0)
    codes = np.concatenate([s0c[..., None], s1c[..., None], s2c[..., None], vc, uc], -1)
    lens = np.concatenate([s0l[..., None], s1l[..., None], s2l[..., None], vl, ul], -1)
    return codes, lens, rung, factors[-1]


def pack_bits(codes, lens):
    """Symbols in stream order -> (bytes, total bits): each code's bits LSB
    first, one after another, into little-endian bytes."""
    codes, lens = codes.reshape(-1), lens.reshape(-1).astype(np.int64)
    end = np.cumsum(lens)
    total = int(end[-1]) if end.size else 0
    pos = end - lens
    live = lens > 0
    c, p, n = codes[live].astype(np.uint64), pos[live], lens[live]
    words = np.zeros(total // 64 + 2, np.uint64)
    sh = (p & 63).astype(np.uint64)
    np.bitwise_or.at(words, p >> 6, c << sh)
    over = (p & 63) + n > 64
    np.bitwise_or.at(words, (p >> 6)[over] + 1, c[over] >> (np.uint64(64) - sh[over]))
    return words.astype("<u8").view(np.uint8)[: (total + 7) // 8].tobytes(), total


def ic_sidecar(glen, rung, k: int = IC_K):
    """The "ic" sidecar: u16 k (bit 15: spans in u32), each chunk's bit span
    (k blocks of every band), then each chunk's entry rung of every band
    (0 for the first; the rung of the chunk's previous block)."""
    nblocks, nb = rung.shape
    nchunks = -(-nblocks // k)
    g = np.zeros(nchunks * k * nb, np.int64)
    g[: glen.size] = glen.reshape(-1)
    spans = g.reshape(nchunks, -1).sum(-1)
    if int(spans.sum()) >= 1 << 31:
        return None
    entry = np.zeros((nchunks, nb), np.uint8)
    entry[1:] = rung[k - 1: (nchunks - 1) * k: k]
    wide = int(spans.max()) > 0xFFFF
    return (struct.pack("<H", k | (_IC_WIDE if wide else 0))
            + spans.astype("<u4" if wide else "<u2").tobytes() + entry.tobytes())


def header(w: int, h: int, nb: int, dtype: int, mode: int, cband, index=None,
           sig: bytes = b"ic", order: int = HILBERT, quanta: int = 1) -> bytes:
    """Main header ("QB3\\x80", sizes less one, bands less one, type, mode),
    then the chunks: "CB" core bands where one differs from its band, "QV"
    the step where it is 2 or more (u16 byte count, then the step in as few
    little-endian bytes as hold it), "SC" the curve where it is not the
    z-curve, the sidecar in pieces of at most 65530 bytes (each chunk's u16
    length counts its own 4 header bytes), and "DT", which the payload
    follows.  A stored stream keeps only "QV"."""
    out = b"QB3\x80" + struct.pack("<HHBBB", w - 1, h - 1, nb - 1, dtype, mode)
    if mode != STORED and any(cband[c] != c for c in range(nb)):
        out += b"CB" + struct.pack("<H", nb) + bytes(cband)
    if quanta >= 2:
        size = (int(quanta).bit_length() + 7) // 8
        out += b"QV" + struct.pack("<H", size) + int(quanta).to_bytes(size, "little")
    if mode == STORED:
        return out + b"DT"
    if order != ZCURVE:
        out += b"SC" + struct.pack("<HQ", 8, order)
    for pos in range(0, len(index or b""), 65530):
        piece = index[pos: pos + 65530]
        out += sig + struct.pack("<H", len(piece) + 4) + piece
    return out + b"DT"


# ------------------------------------------------------------------ quanta

def quantize(img: np.ndarray, q: int, away: bool = False) -> np.ndarray:
    """Each value divided by the step q in the signed domain, rounded to the
    nearest whole number, a tie toward zero, or away from it with away
    (QB3encode.cpp:137-186)."""
    v = img.astype(np.int64)
    r, rem = np.divmod(np.abs(v), q)
    r += (2 * rem > q) | ((2 * rem == q) & away)
    return (np.sign(v) * r).astype(img.dtype)


def dequantize(img: np.ndarray, q: int) -> np.ndarray:
    """Each value times the step q, held at the type's largest value, and in
    a signed type with q > 2 at its smallest; a product outside the type
    otherwise wraps (QB3decode.cpp:77-107)."""
    lim = np.iinfo(img.dtype)
    v = np.minimum(img.astype(np.int64) * q, lim.max)
    if lim.min < 0 and q > 2:
        v = np.maximum(v, lim.min)
    return v.astype(img.dtype)


# ------------------------------------------------------------------ RLE0

def rle0_encode(data: bytes) -> bytes:
    """The RLE0 byte pass over a payload (doc/QB3.md): "ff ff ff" stands for
    two 0xff bytes and "ff ff n" (n < 0xff) for 4 + n zero bytes.  Pairs of
    0xff are taken from the start of each run of them; a run of 4 or more
    zeros goes in pieces of at most 258, but one zero goes first as itself
    where the byte before is a lone 0xff, which would read as an escape
    with them.  No escape starts in the last two bytes."""
    buf = np.frombuffer(data, np.uint8)
    n = buf.size
    if n < 3:
        return data
    edge = np.flatnonzero(buf[1:] != buf[:-1]) + 1
    start = np.concatenate([[0], edge])
    length = np.diff(np.concatenate([start, [n]]))
    val = buf[start]
    runs = (val == 0xFF) | ((val == 0) & (length >= 4))
    out, pos, lone_ff = bytearray(), 0, False
    for s, k, v in zip(start[runs].tolist(), length[runs].tolist(), val[runs].tolist()):
        if s > pos:
            out += data[pos:s]
            lone_ff = False
        pos = s + k
        if v == 0xFF:
            pairs = min(k // 2, max(0, (n - 1 - s) // 2))  # each starts before n - 2
            out += b"\xff\xff\xff" * pairs + b"\xff" * (k - 2 * pairs)
            lone_ff = k > 2 * pairs
            continue
        if lone_ff:
            out.append(0)
            k -= 1
        while k >= 4:
            piece = min(k, 258)
            out += bytes((0xFF, 0xFF, piece - 4))
            k -= piece
        out += bytes(k)
        lone_ff = False
    return bytes(out + data[pos:])


def rle0_decode(data: bytes, limit: int) -> bytes:
    """Undo rle0_encode; raises where the bytes would pass `limit`, the
    raster's raw size (QB3decode.cpp:267-307, :396-413)."""
    buf = np.frombuffer(data, np.uint8)
    n = buf.size
    pairs = np.flatnonzero((buf[:-1] == 0xFF) & (buf[1:] == 0xFF)) if n > 1 else []
    parts, pos, size = [], 0, 0
    for e in (int(x) for x in pairs):
        if e < pos or e >= n - 2:
            continue
        fill = b"\xff\xff" if buf[e + 2] == 0xFF else bytes(4 + int(buf[e + 2]))
        size += e - pos + len(fill)
        if size > limit:
            raise ValueError("RLE0 expands past the raster's size")
        parts += [data[pos:e], fill]
        pos = e + 3
    if size + n - pos > limit:
        raise ValueError("RLE0 expands past the raster's size")
    return b"".join(parts) + data[pos:]


# ------------------------------------------------------------------ stream

def max_size(w: int, h: int, nb: int, itemsize: int) -> int:
    """The encoder's bound on a stream's bytes (QB3encode.cpp:112-118)."""
    n = 16 * (-(-w // B)) * (-(-h // B)) * nb
    return 1024 + (17 + 128 * itemsize) * n // 128


def _append_bits(out: bytearray, nbits: int, codes, lens) -> int:
    """Pack symbols behind the nbits already in out -> the new bit count."""
    k = nbits & 7
    carry = out.pop() if k else 0  # the last byte's k bits so far
    data, total = pack_bits(np.concatenate([[carry], codes.reshape(-1)]),
                            np.concatenate([[k], lens.reshape(-1)]))
    out += data
    return nbits - k + total


def encode(img: np.ndarray, mode: int = FTL, index=None, cband=None, quanta: int = 1,
           away: bool = False) -> bytes:
    """One raster (H, W, C) of u8, i8, u16 or i16, sides multiples of 4 ->
    its stream in a mode of MODES: FTL, BASE_H (index None or "ic"), CF_H,
    RLE_H or CF_RLE_H (index None); quantized by the step quanta where it is
    2 or more.  The RLE0 modes take the pass where the coded stream is at
    most half the bound and the pass makes the payload smaller and fits the
    bound, and name their coding mode otherwise (QB3encode.cpp:536-566);
    the other modes store the raw raster where the coded stream is not
    smaller than it."""
    h, w, nb = img.shape
    if h % B or w % B or img.dtype not in DTYPES:
        raise ValueError("the reference takes 8- and 16-bit rasters with sides multiples of 4")
    if mode not in MODES.values():
        raise ValueError(f"mode {mode} is not in the reference")
    base = RLE_BASE.get(mode, mode)
    if index is not None and (index != "ic" or mode not in (FTL, BASE_H)):
        raise ValueError("the reference writes the ic sidecar, in FTL and BASE_H")
    tbits = 8 * img.dtype.itemsize
    cband = list(cband) if cband is not None else default_cband(nb)
    prev, old, last = (np.zeros(nb, np.int64) for _ in range(3))
    payload, nbits, glens, rungs = bytearray(), 0, [], []
    rows = B * max(1, SLICE_GROUPS // (w // B * nb))
    for y in range(0, h, rows):  # block rows, each band's state carried over
        part = quantize(img[y: y + rows], quanta, away) if quanta >= 2 else img[y: y + rows]
        m, prev = groups_of(part.view(UNSIGNED[img.dtype.itemsize]), cband, prev=prev)
        if base == CF_H:
            codes, lens, rung, last = best_symbols(m, tbits, old, last)
        else:
            codes, lens, rung = fast_symbols(m, base != FTL, tbits, old)
        old = rung[-1]
        glens.append(lens.sum(-1))
        rungs.append(rung)
        nbits = _append_bits(payload, nbits, codes, lens)
    side = ic_sidecar(np.concatenate(glens), np.concatenate(rungs)) if index else None
    dt = DTYPES[img.dtype]
    out = header(w, h, nb, dt, base, cband, side, quanta=quanta) + payload
    if base != mode:
        bound = max_size(w, h, nb, img.dtype.itemsize)
        if len(out) <= bound // 2:
            packed = rle0_encode(bytes(payload))
            if len(packed) < len(payload) and len(packed) <= bound - len(out):
                return header(w, h, nb, dt, mode, cband, side, quanta=quanta) + packed
        return out
    if img.nbytes > len(out):
        return out
    return header(w, h, nb, dt, STORED, cband, quanta=quanta) + img.tobytes()


# ------------------------------------------------------------------ decode

def parse_header(stream: bytes) -> dict:
    """The main header and chunks -> width, height, bands, dtype, mode,
    cband, quanta, order, offset of the payload."""
    if stream[:4] != b"QB3\x80":
        raise ValueError("not a QB3 stream")
    w, h, nb, dt, mode = struct.unpack("<HHBBB", stream[4:11])
    info = dict(w=w + 1, h=h + 1, nb=nb + 1, dtype=dt, mode=mode, quanta=1,
                cband=list(range(nb + 1)), order=ZCURVE if mode in (0, 1, 2, 3) else HILBERT)
    pos = 11
    while stream[pos: pos + 2] != b"DT":
        sig = stream[pos: pos + 2]
        (ln,) = struct.unpack("<H", stream[pos + 2: pos + 4])
        body = stream[pos + 4: pos + 4 + ln]
        if sig == b"CB":
            info["cband"] = list(body)
        elif sig == b"SC":
            (info["order"],) = struct.unpack("<Q", body)
        elif sig == b"QV":
            info["quanta"] = int.from_bytes(body, "little")
        if sig[0] & 0x20:  # a skippable chunk: its length counts its header
            pos += ln
        else:
            pos += 4 + ln
    info["offset"] = pos + 2
    return info


def _dec_table(rung: int, group: bool):
    """rung <= 7: the low rung + 2 bits -> (len, value)."""
    vals = np.arange(1 << (rung + 1))
    code, ln = group_code(vals, rung) if group else single_code(vals, rung)
    out = [None] * (1 << (rung + 2))
    for v, c, n in zip(vals, code, ln):
        for hi in range(1 << (rung + 2 - int(n))):
            out[(hi << int(n)) | int(c)] = (int(n), int(v))
    return out


_DEC_GROUP = [None] + [_dec_table(r, True) for r in range(1, 8)]
_DEC_SINGLE = [_dec_table(r, False) for r in range(8)]


def _dsw_table(u: int):
    """The u + 1 bits after a codeswitch's 1 flag -> (len with the flag,
    delta); the SIGNAL reads as delta 0 at its long length."""
    table, sig = CSW[u]
    out = [None] * (1 << (u + 1))
    for d in range(1, 1 << u):
        c, n = int(table[d, 0]) >> 1, int(table[d, 1]) - 1
        for hi in range(1 << (u + 1 - n)):
            out[(hi << n) | c] = (n + 1, d)
    c, n = sig[0] >> 1, sig[1] - 1
    for hi in range(1 << (u + 1 - n)):
        out[(hi << n) | c] = (n + 1, 0)
    return out


_DSW = {u: _dsw_table(u) for u in (3, 4)}


class _Bits:
    """LSB-first bit reader."""

    def __init__(self, data: bytes):
        self.data, self.pos = data + bytes(16), 0

    def peek(self) -> int:
        b = self.pos >> 3
        return int.from_bytes(self.data[b: b + 9], "little") >> (self.pos & 7)

    def take(self, n: int) -> int:
        v = self.peek() & ((1 << n) - 1)
        self.pos += n
        return v


def _value(bits: _Bits, rung: int, group: bool) -> int:
    w = bits.peek()
    if rung <= 7:
        n, v = (_DEC_GROUP if group else _DEC_SINGLE)[rung][w & ((1 << (rung + 2)) - 1)]
    else:
        top = 1 << rung
        if not w & 1:
            n, v = rung, (w & (top - 1)) >> 1
        elif not w & 2:
            n, v = rung + 1, ((w >> 2) & (top - 1)) | (top >> 1)
        else:
            n, v = rung + 2, ((w >> 2) & (top - 1)) | top
    bits.pos += n
    return v


def _unstep(vals: list, rung: int) -> list:
    """Undo the step encoding: where the rung bits read 1...10...0 (k ones),
    value k, if there is one, gets its rung bit back."""
    acc = 0
    for i, v in enumerate(vals):
        acc |= ((v >> rung) & 1) << i
    if acc & (acc + 1) == 0 and acc.bit_length() < B2:
        vals[acc.bit_length()] ^= 1 << rung
    return vals


def decode_groups(payload: bytes, nblocks: int, nb: int, tbits: int, mode: int) -> np.ndarray:
    """Walk the payload -> (nblocks, C, 16) mag-sign values."""
    u = ubits(tbits)
    nmask, lmask, mask = (1 << u) - 1, (1 << (u + 1)) - 1, (1 << tbits) - 1
    dsw = _DSW[u]
    bits = _Bits(payload)
    runbits, pcf = [0] * nb, [0] * nb
    out = np.zeros((nblocks, nb, B2), np.int64)
    for b in range(nblocks):
        for c in range(nb):
            w = bits.peek()
            n, d = dsw[(w >> 1) & lmask] if w & 1 else (1, 0)
            bits.pos += n
            if mode == FTL or not (w & 1 and d == 0):  # an ordinary group
                rung = runbits[c] = (runbits[c] + d) & nmask
                if rung == 0:
                    if bits.take(1):
                        out[b, c] = [bits.take(1) for _ in range(B2)]
                    continue
                vals = [_value(bits, rung, True) for _ in range(B2)]
                out[b, c] = _unstep(vals, rung) if mode != FTL else vals
                continue
            n, d = dsw[bits.peek() & lmask]  # flagless
            bits.pos += n - 1
            rung = (runbits[c] + d) & nmask
            if rung != nmask:  # common factor
                if bits.take(1):
                    own = bits.take(1)
                    cfrung = rung
                    if own:
                        n, d = dsw[bits.peek() & lmask]
                        bits.pos += n - 1
                        cfrung = (rung + d) & nmask
                    v = _value(bits, cfrung - own, False)
                    pcf[c] = v + ((1 << cfrung) if own else 0)
                cf = pcf[c] + 2
                if rung == 0:
                    vals = [bits.take(1) for _ in range(B2)]
                    runbits[c] = (2 * cf - 1).bit_length() - 1
                else:
                    vals = _unstep([_value(bits, rung, True) for _ in range(B2)], rung)
                vals = [(((v >> 1) + (v & 1)) * 2 * cf - (v & 1)) & mask for v in vals]
                if rung:
                    used = 0
                    for v in vals:
                        used |= v
                    runbits[c] = max((used | 1).bit_length() - 1, 0)
                out[b, c] = vals
            else:  # index
                n, d = dsw[bits.peek() & lmask]
                bits.pos += n - 1
                rung = runbits[c] = (runbits[c] + d) & nmask
                idx = [_value(bits, 2, False) for _ in range(B2)]
                uniq = [_value(bits, rung, False) for _ in range(max(idx) + 1)]
                out[b, c] = [uniq[i] for i in idx]
    return out


def decode(stream: bytes) -> np.ndarray:
    """A stream of FTL, BASE_H, CF_H, RLE_H or CF_RLE_H (any sidecar is
    skipped), or a stored one, 8- or 16-bit, sides multiples of 4 -> the
    (H, W, C) raster, multiplied back by its step where it has one."""
    i = parse_header(stream)
    h, w, nb = i["h"], i["w"], i["nb"]
    dt = np.dtype(NP_DTYPES[i["dtype"]])
    data = stream[i["offset"]:]
    if i["mode"] == STORED:
        return np.frombuffer(data, dt).reshape(h, w, nb).copy()
    mode = RLE_BASE.get(i["mode"], i["mode"])
    if mode not in (FTL, BASE_H, CF_H) or h % B or w % B:
        raise ValueError("the reference decodes the modes of MODES, sides multiples of 4")
    if mode != i["mode"]:
        data = rle0_decode(data, h * w * nb * dt.itemsize)
    tbits = 8 * dt.itemsize
    mask = (1 << tbits) - 1
    m = decode_groups(data, (h // B) * (w // B), nb, tbits, mode)
    seq = np.cumsum(smags(m.transpose(1, 0, 2).reshape(nb, -1), tbits), axis=1) & mask
    vals = seq.reshape(nb, -1, B2).transpose(1, 0, 2)
    t = np.empty_like(vals)
    t[..., curve_lanes(i["order"])] = vals
    img = t.reshape(h // B, w // B, nb, B, B).transpose(0, 3, 1, 4, 2).reshape(h, w, nb)
    cb = i["cband"]
    dep = [c for c in range(nb) if cb[c] != c]
    img[..., dep] = (img[..., dep] + img[..., [cb[c] for c in dep]]) & mask
    img = img.astype(UNSIGNED[dt.itemsize]).view(dt)
    return dequantize(img, i["quanta"]) if i["quanta"] >= 2 else img
