"""Wrapper of the CUDA kernel K8 (fused image-layout VLC + pack), with its
plain PyTorch twin and launch counter.

Counterpart of qb3_tpu/ops/encode_pallas.py.  The wrapper takes its plain
twin for a CPU tensor and launches its kernel (csrc/encode_image.cu) for a
CUDA tensor; there is no fallback from one to the other.  Its ``launches``
attribute counts its kernel launches.
"""

from __future__ import annotations

import torch

from .. import _build
from ..constants import B, B2, curve_offsets
from .bitpack import group_bits_bound, pack_groups
from .encode import value_codes_arith
from .pack_cuda import PACK_G, on_cpu, pack_buffers, require, stream_ptr

_K8 = _build.Kernel("qb3_encode_pack_image")


def _check_shapes(m, groups):
    """m must be (H, W, C) with H and W multiples of 4, and each per-group
    array (H/4 * W/4 * C,)."""
    h, w, nb = m.shape
    if h % B or w % B:
        raise ValueError(f"plane {tuple(m.shape)}: H and W must be multiples of {B}")
    for x in groups:
        if x.shape != (h // B * (w // B) * nb,):
            raise ValueError(f"per-group array {tuple(x.shape)}: expected one per group")


def image_pack_args(o: dict, tbits: int, n_words: int, order: int) -> tuple:
    """phase_a_image's result `o` as encode_pack_image and its twin take
    it: (m, rung, gkind, pcode, plen, glen, tbits, n_words, order), the
    per-group fields flat."""
    return (o["m"], o["rung"].reshape(-1), o["gkind"], o["prefix_code"].reshape(-1),
            o["prefix_len"].reshape(-1), o["glen"], tbits, n_words, order)


def encode_pack_image_plain(m, rung, gkind, pcode, plen, glen, tbits: int, n_words: int,
                            order: int):
    """K8's twin: the groups' values reordered into (ngroups, 16) curve
    order, coded by value_codes_arith and packed by bitpack.pack_groups.
    Raises if the lengths it emits disagree with glen."""
    _check_shapes(m, (rung, gkind, pcode, plen, glen))
    h, w, nb = m.shape
    perm = torch.tensor([dy * B + dx for dy, dx in curve_offsets(order)], device=m.device)
    vals = m.reshape(h // B, B, w // B, B, nb).permute(0, 2, 4, 1, 3).reshape(-1, B2)[:, perm]
    codes, lens, ebits, elens = value_codes_arith(vals, rung, True, tbits)
    kind = gkind[:, None]
    codes = torch.where(kind == 0, codes, torch.where(kind == 1, vals & 1, 0))
    lens = torch.where(kind == 0, lens, (kind == 1).to(lens.dtype))
    if tbits == 64:
        # value codes and their 65th bits interleaved: v0, e0, v1, e1, ...
        codes = torch.stack([codes, torch.where(kind == 0, ebits, 0)], -1).flatten(-2)
        lens = torch.stack([lens, torch.where(kind == 0, elens, 0)], -1).flatten(-2)
    codes = torch.cat([pcode[:, None], codes], -1)
    lens = torch.cat([plen[:, None], lens], -1)
    if not torch.equal(lens.sum(-1), glen.to(torch.int64)):
        raise ValueError("the emitted group lengths disagree with glen")
    return pack_groups(codes, lens, n_words, group_bits_bound(tbits, best=False))


def encode_pack_image(m, rung, gkind, pcode, plen, glen, tbits: int, n_words: int,
                      order: int):
    """K8: pack an image's groups straight from its mag-sign plane.

    m: (H, W, C) int64 mag-sign carrier (step-flipped for BASE), H and W
    multiples of 4; rung, gkind (0 normal / 1 bits / 2 zero),
    pcode, plen, glen: (ngroups,) int64 in raster-block x band order; order:
    the scan curve.  Returns (words (n_words,) int32 u32 patterns, total
    bits int64, glen int32), as K1's wrapper does, after one memset and
    one launch: the kernel scans glen itself.  At most 256 bands."""
    if on_cpu(m):
        return encode_pack_image_plain(m, rung, gkind, pcode, plen, glen, tbits, n_words,
                                       order)
    require(m, torch.int64, "m", 3)
    groups = {"rung": rung, "gkind": gkind, "pcode": pcode, "plen": plen, "glen": glen}
    for name, x in groups.items():
        require(x, torch.int64, name, 1, m.device)
    _check_shapes(m, groups.values())
    h, w, nb = m.shape
    if nb > 2 * PACK_G:
        raise ValueError(f"{nb} bands: the kernel takes at most {2 * PACK_G}")
    nby, nbx = h // B, w // B
    nblocks = nby * -(-nbx // max(1, PACK_G // nb))  # blocks of one block-row's groups
    words, total, glen32, ptrs = pack_buffers((), rung.shape[0], n_words, nblocks, m.device)
    _K8(m.data_ptr(), rung.data_ptr(), gkind.data_ptr(), pcode.data_ptr(), plen.data_ptr(),
        glen.data_ptr(), nby, nbx, nb, order, n_words, *ptrs, nblocks, stream_ptr(m.device))
    encode_pack_image.launches += 1
    return words, total, glen32


encode_pack_image.launches = 0
