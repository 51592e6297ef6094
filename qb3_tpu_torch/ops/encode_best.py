"""Vectorized best-mode encoding: the common-factor and index group trials.

PyTorch counterpart of qb3_tpu/ops/encode_best.py.  The reference's
encode_best (QB3encode.h:618-724) trial-encodes each group and rewinds its
output when the index encoding is smaller, a serial construction.  Here the
exact bit length of every candidate is computed for all groups at once and
each group *selects* one, which gives the same stream:

  * per group: plain, CF (cfgenc, QB3encode.h:284-361) and index (ienc,
    QB3encode.h:557-613) code words and lengths;
  * the per-band previous-CF chain (pcf) feeds back into the choice, but a
    group's pcf transition is either the identity (the index encoding would
    win against the different-CF candidate) or set-to-(cf - 2), never a
    function of the incoming value, so the chain is a "last set wins" scan
    (pcf_scan).

Values ride in int64 carriers (bitutils.py): a 64-bit magnitude may be
2^63, negative as int64, so the CF test ((cf & ~1) != 0 for cf >= 2), the
GCD (group_gcd) and the division (bitutils.magsdiv) treat it as unsigned.
Every function takes optional leading batch axes ahead of the per-image
axes.

Symbols per block/band: 3 prefix symbols (the codeswitch or SIGNAL header,
the CF rung switch, the CF value), 16 value codes (with their 65th bits for
64-bit data, interleaved), 8 index uniques: 27 symbols, 43 for u64.
"""

from __future__ import annotations

import torch

from .. import tables as T
from ..constants import B2, ubits_for
from ..offsets import KIND_BITS, KIND_CF, KIND_CF0, KIND_IDX, KIND_NORMAL, KIND_ZERO
from .bitutils import magsabs, magsdiv, topbit
from .encode import block_rungs, csw_arith, delta_mags, gather_blocks, value_codes_arith

_U = B2 // 2  # index uniques at most
_SORT_LAST = 99  # the sort key of a dead unique slot: after every live count


def group_gcd(m, tbits: int):
    """Greatest common factor of the mag-sign magnitudes of each group
    (QB3encode.h:98-126): (..., B2) -> (...), 0 if all are zero.

    gcd is associative and unique, so a pairwise tree of torch.gcd gives
    what qb3_tpu's fixed-round binary GCD gives.  torch.gcd takes operands
    below 2^63; the one 64-bit magnitude past that, 2^63 (of 2^64 - 1, -2^63
    as int64), has gcd(2^63, y) = the lowest set bit of y (y != 0), and
    gcd(2^63, 0) = 2^63.
    """
    a = magsabs(m)
    big = -(1 << 63)
    while a.shape[-1] > 1:
        half = a.shape[-1] // 2
        x, y = a[..., :half], a[..., half:]
        if tbits < 64:
            a = torch.gcd(x, y)
        else:
            xb, yb = x == big, y == big
            g = torch.gcd(torch.where(xb, 0, x), torch.where(yb, 0, y))
            a = torch.where(xb, torch.where(y == 0, x, y & -y),
                            torch.where(yb, torch.where(x == 0, y, x & -x), g))
    return a[..., 0]


def single_codes(v, rung):
    """qb3csztbl: single-value codes at any rung (QB3encode.h:144-150): the
    base VLC and the rung 3..7 middle swap (the single-value context has no
    rung 1/2 swap).  v: values below 2^(rung + 1); rung <= 62.  Returns
    (code, len)."""
    a = (1 << rung.clamp(0, 7)) - 1
    do_swap = (rung >= 3) & (rung <= 7)
    v = torch.where(do_swap & (v == a), a + 1, torch.where(do_swap & (v == a + 1), a, v))
    r = rung.clamp(min=1)
    nxt = (v >> (r - 1)) & 1
    top = v >> r
    tb = 1 << r
    cl = r + top + (top | nxt)
    cc = torch.where(top == 1, ((v ^ tb) << 2) | 3,
                     torch.where(nxt == 1, (((v << 1) ^ tb) << 1) | 1, v << 1))
    # rung 0: one literal bit
    return torch.where(rung == 0, v & 1, cc), torch.where(rung == 0, 1, cl)


def _flagless(code, ln):
    """Drop the codeswitch change flag (cfgenc / ienc emit it apart or not
    at all, QB3encode.h:300-305, :581-592)."""
    return code >> 1, ln - 1


def _cs_or_signal(ubits: int, delta):
    """Codeswitch code for a rung delta, the len-1 no-change form replaced
    by the SIGNAL long form (QB3encode.h:301-303)."""
    code, ln = csw_arith(delta, torch.zeros_like(delta), ubits)
    sig_len, sig_code = int(T.SIGNAL[ubits, 0]), int(T.SIGNAL[ubits, 1])
    use_sig = ln == 1
    return torch.where(use_sig, sig_code, code), torch.where(use_sig, sig_len, ln)


def index_candidate(m, rung, oldrung, ubits: int):
    """ienc: the index group encoding (QB3encode.h:557-613).

    m: (..., C, B2) mag-sign values.  Returns (prefix code, prefix len,
    index codes, index lens (..., B2), unique codes, unique lens (..., 8),
    total len, valid).  qb3_tpu takes its small gathers as one-hot sums (a
    TPU's per-element gathers are slow); here they are gathers, to the same
    values.
    """
    nmask = (1 << ubits) - 1
    lane = torch.arange(B2, device=m.device)
    slot = torch.arange(_U, device=m.device)
    # uniques in first-occurrence order; the (..., 16, 16) compare and the
    # first j with g[j] == g[i] in one byte an element
    eq = m[..., :, None] == m[..., None, :]
    first_occ = torch.where(eq, lane.to(torch.uint8), B2).amin(-1).to(torch.int64)
    is_first = first_occ == lane
    nuniq = is_first.sum(-1)
    valid = nuniq <= _U
    rank = is_first.cumsum(-1) - 1  # slot of each first occurrence
    uid8 = rank.gather(-1, first_occ).clamp(0, _U - 1)  # each value's slot
    counts = torch.zeros(*uid8.shape[:-1], _U, dtype=torch.int64, device=m.device)
    counts.scatter_add_(-1, uid8, torch.ones_like(uid8))
    slot_live = slot < nuniq.clamp(max=_U)[..., None]
    # stable sort by descending count (ties keep first-seen order,
    # QB3encode.h:546-554)
    order = torch.sort(torch.where(slot_live, -counts, _SORT_LAST), dim=-1,
                       stable=True).indices
    inv = torch.empty_like(order).scatter_(-1, order, slot.expand_as(order))
    final_idx = inv.gather(-1, uid8)
    # plain rung-2 index codes (no swap in the single context at rung 2)
    idx_codes, idx_lens = single_codes(final_idx, torch.full_like(final_idx, 2))
    # unique values by slot (first-seen order), then ordered by frequency
    keep = is_first & (rank < _U)
    uniq_slot = torch.zeros(*m.shape[:-1], _U, dtype=torch.int64, device=m.device)
    uniq_slot.scatter_add_(-1, rank.clamp(0, _U - 1), torch.where(keep, m, 0))
    uniq_sorted = uniq_slot.gather(-1, order)
    uc, ul = single_codes(uniq_sorted, rung[..., None].expand_as(uniq_sorted))
    live_sorted = slot_live.gather(-1, order)
    ul = torch.where(live_sorted, ul, 0)
    uc = torch.where(live_sorted, uc, 0)
    # prefix: SIGNAL + flagless cs(max - oldrung) + flagless cs(rung - oldrung)
    sig_len, sig_code = int(T.SIGNAL[ubits, 0]), int(T.SIGNAL[ubits, 1])
    c1, l1 = _flagless(*_cs_or_signal(ubits, (nmask - oldrung) & nmask))
    c2, l2 = _flagless(*_cs_or_signal(ubits, (rung - oldrung) & nmask))
    pcode = sig_code | (c1 << sig_len) | (c2 << (sig_len + l1))
    plen = sig_len + l1 + l2
    total = plen + idx_lens.sum(-1) + ul.sum(-1)
    return pcode, plen, idx_codes, idx_lens, uc, ul, total, valid


def cf_candidate(m, rung, oldrung, ubits: int, tbits: int):
    """cfgenc components for both the same-CF and the different-CF variants
    (QB3encode.h:284-361) -> a dict of code and length tensors; the choice
    comes after the pcf scan."""
    nmask = (1 << ubits) - 1
    cf = group_gcd(m, tbits)  # (..., C), in [0, 2^63]
    has_cf = (cf & ~1) != 0  # cf >= 2, unsigned
    cf_safe = torch.where(has_cf, cf, 2)
    div = magsdiv(m, cf_safe[..., None], tbits)  # the divided group
    bitsused = div[..., 0]
    for i in range(1, B2):
        bitsused = bitsused | div[..., i]
    trung = topbit(bitsused | 1)  # <= 62 where cf >= 2
    cfm = cf_safe - 2  # biased CF
    cfrung = topbit(cfm | 1)

    sig_len, sig_code = int(T.SIGNAL[ubits, 0]), int(T.SIGNAL[ubits, 1])
    cst_c, cst_l = _flagless(*_cs_or_signal(ubits, (trung - oldrung) & nmask))
    # header base: SIGNAL + flagless rung switch
    base_code = sig_code | (cst_c << sig_len)
    base_len = sig_len + cst_l

    at_trung = (trung >= cfrung) & ((trung < cfrung + ubits) | (cfrung == 0))
    trung0 = trung == 0

    # diff-CF, cf at trung: flags '1', '0', then the cf code (1 bit at trung 0)
    cfc_at, cfl_at = single_codes(cfm, trung)
    cfc_at = torch.where(trung0, cfm & 1, cfc_at)
    cfl_at = torch.where(trung0, 1, cfl_at)
    # diff-CF, own rung: flag '1' + the full csw(cfrung - trung) + cf at cfrung - 1
    own_c, own_l = csw_arith(cfrung, trung, ubits)
    cfc_own, cfl_own = single_codes(cfm ^ (1 << cfrung), cfrung - 1)

    # body: the divided group at trung (with step), or 16 single bits at trung 0
    dc, dl, _, _ = value_codes_arith(div, trung, False, tbits)
    dc = torch.where(trung0[..., None], div & 1, dc)
    dl = torch.where(trung0[..., None], 1, dl)
    body_len = dl.sum(-1)

    # the flags follow the header base: same '0'; diff at trung '1' then
    # '0'; diff at its own rung '1' (the csw change bit is the second flag)
    p1_flag = base_code | (1 << base_len)
    l1_diff = torch.where(at_trung, base_len + 2, base_len + 1)
    s1_code_diff = torch.where(at_trung, 0, own_c)
    s1_len_diff = torch.where(at_trung, 0, own_l)
    s2_code_diff = torch.where(at_trung, cfc_at, cfc_own)
    s2_len_diff = torch.where(at_trung, cfl_at, cfl_own)
    return dict(
        cf=cf, has_cf=has_cf, cfm=cfm, trung=trung,
        p1_same=base_code, l1_same=base_len + 1, p1_diff=p1_flag, l1_diff=l1_diff,
        s1_code_diff=s1_code_diff, s1_len_diff=s1_len_diff,
        s2_code_diff=s2_code_diff, s2_len_diff=s2_len_diff,
        body_codes=dc, body_lens=dl,
        size_same=base_len + 1 + body_len,
        size_diff=l1_diff + s1_len_diff + s2_len_diff + body_len,
    )


def pcf_scan(is_set, set_val, entry_cf):
    """Per-band "last set wins" scan over blocks (axis -2).

    is_set: (..., nblocks, C) bool; set_val: (..., nblocks, C); entry_cf:
    (..., C).  Returns (pcf_in, the state before each block; the exit
    state).  The index of the last set block at or before each block is a
    cummax over the set blocks' indices; the value is then one gather.
    """
    nblocks = is_set.shape[-2]
    idx = torch.arange(nblocks, device=is_set.device)[:, None]
    last = torch.where(is_set, idx, -1).cummax(dim=-2).values
    incl = torch.where(last >= 0, set_val.gather(-2, last.clamp(min=0)),
                       entry_cf[..., None, :])
    pcf_in = torch.cat([entry_cf[..., None, :], incl[..., :-1, :]], dim=-2)
    return pcf_in, incl[..., -1, :]


def encode_best_blocks(img, entry_prev, entry_runbits, entry_cf, order: int,
                       cband: tuple[int, ...], tbits: int, cf_exchange=None,
                       prev_exchange=None, rung_exchange=None):
    """Phase A of the best encoder.

    img: (..., H, W, C) int64 carrier of tbits-wide unsigned values;
    entry_prev, entry_runbits, entry_cf: (..., C).  Returns the nine
    outputs of qb3_tpu's: codes (..., ngroups, nsym) int64 and lens int32
    in stream order, exit_prev, exit_runbits, exit_cf (..., C), meta16
    (..., ngroups) int32 (kind | vrung << 3 | prefix_len << 9, the "ib"
    sidecar's), cfv (..., ngroups) (the biased CF of CF / CF0 groups, else
    0), post_runbits (..., nblocks, C) (the runbits a decoder holds after
    each block, for "ic" anchors) and pcf_in (..., nblocks, C) (the biased
    CF state before each block).

    A sharded caller (parallel/sharded.py) brings in the band state at its
    strip's start through three hooks, as qb3_tpu's does, each a function
    of shard-local data and the shards' collectives: prev_exchange(vals) ->
    (C,) entry_prev; rung_exchange(exit_runbits) -> (C,) entry runbits
    (a strip's exit rung does not depend on its entry rung);
    cf_exchange(is_set, set_val) -> (C,) entry pcf ("last CF set wins"
    across shards: the set decisions do not depend on the entry pcf).
    Without hooks the entry state is the arguments'.
    """
    ubits = ubits_for(tbits // 8)
    vals = gather_blocks(img, order, cband, tbits)
    if prev_exchange is not None:
        entry_prev = prev_exchange(vals)
    m, exit_prev = delta_mags(vals, entry_prev, tbits)
    bitsused, rung, oldrung, exit_runbits = block_rungs(m, entry_runbits)
    if rung_exchange is not None:
        entry_runbits = rung_exchange(exit_runbits)
        oldrung = torch.cat([entry_runbits[..., None, :].to(torch.int64), rung[..., :-1, :]],
                            dim=-2)
    rung0 = (bitsused & ~1) == 0  # bitsused <= 1, unsigned
    active = ~rung0

    # ---- candidates
    plain_codes, plain_lens, plain_eb, plain_el = value_codes_arith(m, rung, False, tbits)
    cs_code, cs_len = csw_arith(rung, oldrung, ubits)
    plain_size = cs_len + (plain_lens + plain_el).sum(-1)
    cfd = cf_candidate(m, rung, oldrung, ubits, tbits)
    ipc, ipl, icodes, ilens, ucodes, ulens, isize, ivalid = index_candidate(
        m, rung, oldrung, ubits)

    # ---- index-trial gating (QB3encode.h:700-713)
    thr = 36 + 3 * ubits + 2 * rung
    idx_range = active & (rung > 3) & (rung < 63) & ivalid
    has_cf = cfd["has_cf"]
    base_same = torch.where(has_cf, cfd["size_same"], plain_size)
    base_diff = torch.where(has_cf, cfd["size_diff"], plain_size)
    win_same = idx_range & (base_same >= thr) & (isize < base_same)
    win_diff = idx_range & (base_diff >= thr) & (isize < base_diff)

    # ---- pcf chain: a block keeps the state where the index trial would win
    # against the different-CF candidate, else sets it to cf - 2
    is_set = active & has_cf & ~win_diff
    if cf_exchange is not None:
        entry_cf = cf_exchange(is_set, cfd["cfm"])
    pcf_in, exit_cf = pcf_scan(is_set, cfd["cfm"], entry_cf)
    same = pcf_in == cfd["cfm"]
    use_cf = active & has_cf
    win = torch.where(same, win_same, win_diff)

    # ---- final symbol choice
    p_rung0 = cs_code | ((bitsused & 1) << cs_len)
    cf_p1 = torch.where(same, cfd["p1_same"], cfd["p1_diff"])
    cf_l1 = torch.where(same, cfd["l1_same"], cfd["l1_diff"])
    s0_code = torch.where(rung0, p_rung0, torch.where(win, ipc, torch.where(use_cf, cf_p1,
                                                                            cs_code)))
    s0_len = torch.where(rung0, cs_len + 1, torch.where(win, ipl, torch.where(use_cf, cf_l1,
                                                                             cs_len)))
    # S1 / S2: the different-CF header only
    diff_cf = use_cf & ~same & ~win
    s1_code = torch.where(diff_cf, cfd["s1_code_diff"], 0)
    s1_len = torch.where(diff_cf, cfd["s1_len_diff"], 0)
    s2_code = torch.where(diff_cf, cfd["s2_code_diff"], 0)
    s2_len = torch.where(diff_cf, cfd["s2_len_diff"], 0)
    # V0..15
    r0b, winb, cfb = rung0[..., None], win[..., None], use_cf[..., None]
    v_code = torch.where(r0b, m & 1, torch.where(winb, icodes,
                                                 torch.where(cfb, cfd["body_codes"],
                                                             plain_codes)))
    v_len = torch.where(r0b, (bitsused == 1)[..., None].to(torch.int64),
                        torch.where(winb, ilens, torch.where(cfb, cfd["body_lens"], plain_lens)))
    # the u64 rung-63 overflow bits: only the plain path has them
    plain_only = ~(r0b | winb | cfb)
    e_code = torch.where(plain_only, plain_eb, 0)
    e_len = torch.where(plain_only, plain_el, 0)
    # U0..7 unique values: only where the index encoding wins
    u_code = torch.where(winb, ucodes, 0)
    u_len = torch.where(winb, ulens, 0)

    if tbits == 64:
        v_code = torch.stack([v_code, e_code], dim=-1).flatten(-2)
        v_len = torch.stack([v_len, e_len], dim=-1).flatten(-2)
    codes = torch.cat([s0_code[..., None], s1_code[..., None], s2_code[..., None], v_code,
                       u_code], dim=-1)
    lens = torch.cat([s0_len[..., None], s1_len[..., None], s2_len[..., None], v_len, u_len],
                     dim=-1)

    # ---- per-group decode metadata for the "ib" sidecar (offsets.py kinds)
    is_cf_grp = ~rung0 & ~win & use_cf
    trung = cfd["trung"]
    kind = torch.where(rung0, torch.where(bitsused == 1, KIND_BITS, KIND_ZERO),
                       torch.where(win, KIND_IDX,
                                   torch.where(is_cf_grp,
                                               torch.where(trung == 0, KIND_CF0, KIND_CF),
                                               KIND_NORMAL)))
    vrung = torch.where(rung0, 0, torch.where(is_cf_grp, trung, rung))
    meta16 = kind | (vrung << 3) | ((s0_len + s1_len + s2_len) << 9)
    cfv = torch.where(is_cf_grp, cfd["cfm"], 0)
    # the decoder-observable runbits, for the self-contained "ic" anchors:
    # a decoder recomputes them after CF0 groups from the CF value
    # (QB3decode.h:664), elsewhere they equal `rung`
    cf0_run = topbit((2 * (cfd["cfm"] + 2) - 1) | 1)
    post_runbits = torch.where(kind == KIND_CF0, cf0_run, rung)
    *lead, nblocks, nb, nsym = codes.shape
    return (codes.reshape(*lead, nblocks * nb, nsym),
            lens.reshape(*lead, nblocks * nb, nsym).to(torch.int32),
            exit_prev, exit_runbits, exit_cf,
            meta16.reshape(*lead, nblocks * nb).to(torch.int32),
            cfv.reshape(*lead, nblocks * nb), post_runbits, pcf_in)
