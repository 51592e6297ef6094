"""The sharded encode of qb3_tpu_torch (parallel/sharded.py) against
qb3_tpu's, on the CPU: each case of tests/test_sharded.py and
tests/test_sharded_full.py with the shards on ["cpu"] * n, the in-shard
scatter stitch against qb3_tpu's inside a shard_map, encode_best_blocks'
hooks against qb3_tpu's, the best modes' sidecar rule and the cut-offs, the
ShardGroup's collectives and errors, the device rule, and
dryrun_multichip.  qb3_tpu's sharded functions run on the 8 virtual CPU
devices of tests/conftest.py, once a function; elsewhere the port is held to
qb3_tpu.encode, to keep XLA compiles few.  The tolerance is zero: bytes
and arrays are equal.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import qb3_tpu
from qb3_tpu import container as jcontainer
from qb3_tpu.ops import encode_best as jbest
from qb3_tpu.parallel import sharded as jsh
from qb3_tpu.stitch import scatter_stitch_shard as j_scatter_stitch_shard
from qb3_tpu_torch import api, container, framing
from qb3_tpu_torch.api import default_cband, to_carrier
from qb3_tpu_torch.constants import HILBERT, Mode
from qb3_tpu_torch.errors import QB3ShapeError
from qb3_tpu_torch.ops import encode_best as tbest
from qb3_tpu_torch.parallel import sharded as tsh
from qb3_tpu_torch.stitch import assemble_scatter, scatter_stitch_shard, stitch_bytes

from . import corpus
from .best_edges import kinds_scene


def cpu(n):
    return ["cpu"] * n


def payload_of(stream: bytes) -> bytes:
    return stream[jcontainer.parse_headers(stream).data_offset:]


# ---------------------------------------------- tests/test_sharded.py's cases

@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_sharded_ftl_byte_exact(n_dev):
    img = corpus.natural8(32 * n_dev, 64, 1, seed=100 + n_dev)
    payload, totals = tsh.encode_fast_sharded(img, n_dev, cband=(0,), devices=cpu(n_dev))
    assert payload == payload_of(qb3_tpu.encode(img, mode=Mode.FTL))
    assert totals.shape == (n_dev,) and int(totals.sum()) <= 8 * len(payload)
    if n_dev == 4:  # qb3_tpu's own sharded encode, once
        jp, jt = jsh.encode_fast_sharded(img, n_dev, cband=(0,))
        assert payload == jp
        np.testing.assert_array_equal(totals, jt)


def test_sharded_rgb():
    img = corpus.natural8(64, 48, 3, seed=110)
    payload, _ = tsh.encode_fast_sharded(img, 4, cband=(1, 1, 1), devices=cpu(4))
    assert payload == payload_of(qb3_tpu.encode(img, mode=Mode.FTL, coreband=[1, 1, 1]))


def test_sharded_u64():
    img = corpus.to_type(corpus.natural8(64, 32, 1, seed=111), np.uint64, 1 << 40)
    payload, _ = tsh.encode_fast_sharded(img, 8, cband=(0,), devices=cpu(8))
    assert payload == payload_of(qb3_tpu.encode(img, mode=Mode.FTL))


def test_scatter_equals_all_gather_encode():
    img = corpus.natural8(64, 48, 3, seed=340)
    p1, t1 = tsh.encode_fast_sharded(img, 8, cband=(1, 1, 1), devices=cpu(8))
    p2, t2 = tsh.encode_fast_sharded_scatter(img, 8, cband=(1, 1, 1), devices=cpu(8))
    jp, jt = jsh.encode_fast_sharded_scatter(img, 8, cband=(1, 1, 1))
    assert p1 == p2 == jp
    np.testing.assert_array_equal(t2, jt)


def test_scatter_stitch_zero_own_shards():
    """Shards owning zero whole output words (tiny, highly compressible
    strips) still contribute their bits: assemble_scatter ORs the shared
    boundary word."""
    rng = np.random.default_rng(341)
    for trial in range(6):
        img = (rng.integers(0, 2, (32, 4, 1)) * 255).astype(np.uint8)
        p1, _ = tsh.encode_fast_sharded(img, 8, devices=cpu(8))
        p2, _ = tsh.encode_fast_sharded_scatter(img, 8, devices=cpu(8))
        assert p1 == p2 == payload_of(qb3_tpu.encode(img, mode=Mode.FTL, coreband=[0])), \
            f"trial {trial}"


# ----------------------------------------- tests/test_sharded_full.py's cases

@pytest.mark.parametrize("mode", [Mode.FTL, Mode.BASE_H, Mode.BASE_Z])
def test_framed_fast_modes(mode):
    img = corpus.natural8(64, 48, 3, seed=130)
    s = tsh.encode_sharded(img, 4, mode=mode, devices=cpu(4))
    assert s == qb3_tpu.encode(img, mode=mode)
    if mode == Mode.BASE_Z:  # qb3_tpu's own framed encode, once
        assert s == jsh.encode_sharded(img, 4, mode=mode)


def test_framed_best_mode():
    img = corpus.natural8(64, 40, 2, seed=131)
    img[:, :, 1] = (img[:, :, 1] // 3) * 9  # plant CFs so pcf chains matter
    s = tsh.encode_sharded(img, 4, mode=Mode.CF_H, devices=cpu(4))
    assert s == qb3_tpu.encode(img, mode=Mode.CF_H)


def test_framed_best_pcf_across_shards():
    """A CF set in shard k feeds shard k + 1's same / diff decision."""
    img = corpus.natural8(96, 32, 1, seed=132).astype(np.uint16) * 257
    s = tsh.encode_sharded(img, 8, mode=Mode.CF_H, devices=cpu(8))
    assert s == qb3_tpu.encode(img, mode=Mode.CF_H)
    assert s == jsh.encode_sharded(img, 8, mode=Mode.CF_H)


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_framed_best_every_kind(n_dev):
    """Best-mode strips whose groups reach every kind (CF, CF0, IDX among
    them), with the "ib" sidecar, across 2-8 shards."""
    img = kinds_scene(32, 24, 3, np.uint8, 40 + n_dev)
    s = tsh.encode_sharded(img, n_dev, mode=Mode.CF_H, index=True, devices=cpu(n_dev))
    assert s == qb3_tpu.encode(img, mode=Mode.CF_H, index=True)


def test_framed_quanta_rle():
    img = np.zeros((64, 64, 1), np.uint8)
    img[8:24, 8:40] = 144
    s = tsh.encode_sharded(img, 4, mode=Mode.RLE_H, quanta=4, devices=cpu(4))
    assert s == qb3_tpu.encode(img, mode=Mode.RLE_H, quanta=4)
    info = container.parse_headers(s)
    assert info.mode == Mode.RLE_H and info.quanta == 4


@pytest.mark.parametrize("index", [True, "ic"], ids=["ix", "ic"])
def test_framed_sidecars_decode(index):
    img = corpus.natural8(64, 64, 3, seed=133)
    s = tsh.encode_sharded(img, 4, mode=Mode.FTL, index=index, devices=cpu(4))
    assert s == qb3_tpu.encode(img, mode=Mode.FTL, index=index)
    info = container.parse_headers(s)
    assert (info.index if index is True else info.index_chunked) is not None
    dec = qb3_tpu.Decoder(s)
    np.testing.assert_array_equal(dec.read_data(), img)
    assert dec.decode_path == ("ix" if index is True else "ic")


def test_framed_coreband():
    img = corpus.natural8(64, 32, 3, seed=134)
    s = tsh.encode_sharded(img, 8, mode=Mode.FTL, coreband=[1, 1, 1], devices=cpu(8))
    assert s == qb3_tpu.encode(img, mode=Mode.FTL)  # [1, 1, 1] is the RGB default


def test_stored_fallback():
    img = corpus.random_noise(16, 16, 1, np.uint8, seed=135)
    s = tsh.encode_sharded(img, 4, mode=Mode.FTL, devices=cpu(4))
    assert container.parse_headers(s).mode == Mode.STORED
    assert s == qb3_tpu.encode(img, mode=Mode.FTL)


@pytest.mark.parametrize("mode", [Mode.RLE, Mode.RLE_H], ids=["rle", "rle-h"])
def test_stored_fallback_after_rle(mode):
    """qb3_tpu's encode_sharded stores an incompressible raster after an RLE
    mode whose post-pass is not taken; the one-shot encode, the port's and
    qb3_tpu's, keeps the coded stream (framing.py's store_rle)."""
    img = corpus.random_noise(16, 16, 1, np.uint8, seed=135)
    s = tsh.encode_sharded(img, 4, mode=mode, devices=cpu(4))
    assert s == jsh.encode_sharded(img, 4, mode=mode)
    assert container.parse_headers(s).mode == Mode.STORED
    one = api.encode(img, mode=mode, device="cpu")
    assert one == qb3_tpu.encode(img, mode=mode)
    assert container.parse_headers(one).mode != Mode.STORED and len(one) > len(s)


def test_2d_mesh_batch_rows():
    tiles = np.stack([corpus.natural8(32, 32, 3, seed=140 + i) for i in range(4)])
    payloads = tsh.encode_tiles_sharded(tiles, n_batch=2, n_rows=4, devices=cpu(8))
    assert payloads == jsh.encode_tiles_sharded(tiles, n_batch=2, n_rows=4)
    for i in range(4):
        assert payloads[i] == payload_of(qb3_tpu.encode(tiles[i], mode=Mode.FTL,
                                                        coreband=[0, 1, 2])), f"tile {i}"


def test_2d_mesh_u16_tiles():
    tiles = np.stack([corpus.to_type(corpus.natural8(16, 24, 2, seed=150 + i), np.uint16, 257)
                      for i in range(6)])
    payloads = tsh.encode_tiles_sharded(tiles, n_batch=3, n_rows=2, devices=cpu(6))
    for i in range(6):
        assert payloads[i] == payload_of(qb3_tpu.encode(tiles[i], mode=Mode.FTL,
                                                        coreband=[0, 1])), f"tile {i}"


def test_shape_errors():
    img = corpus.natural8(60, 32, 1, seed=141)  # 60 is not a multiple of 4 * 8
    with pytest.raises(QB3ShapeError):
        tsh.encode_sharded(img, 8, devices=cpu(8))
    tiles = np.zeros((3, 16, 16, 1), np.uint8)
    with pytest.raises(QB3ShapeError):
        tsh.encode_tiles_sharded(tiles, 2, 2, devices=cpu(4))  # 3 tiles over 2 groups


# ------------------------------------------- the stitch and phase A's hooks

@pytest.mark.parametrize("totals", [(37, 0, 64, 100), (0, 0, 5, 288), (64, 128, 1, 31),
                                    (288, 288, 288, 288), (0, 0, 0, 0)])
def test_scatter_stitch_shard_matches_qb3_tpu(totals):
    """scatter_stitch_shard on a ShardGroup against qb3_tpu's inside a
    shard_map over 4 devices: own words, n_own and nbits, with shards that
    own zero words, word-aligned offsets and an odd word count; and the
    host assembly equals the plain stitch."""
    n, nw32 = 4, 9
    rng = np.random.default_rng(sum(totals))
    words = rng.integers(0, 1 << 32, (n, nw32), dtype=np.uint64).astype(np.uint32)
    nbits = np.array(totals, np.int64)
    mesh = Mesh(np.array(jax.devices()[:n]), ("tiles",))

    def shard(w, b):
        return tuple(x[None] for x in j_scatter_stitch_shard(w[0], b[0], "tiles"))

    want = jax.jit(jax.shard_map(shard, mesh=mesh, in_specs=(P("tiles"), P("tiles")),
                                 out_specs=(P("tiles"),) * 3))(
        jnp.asarray(words), jnp.asarray(nbits))
    group = tsh.ShardGroup(cpu(n))
    got = group.run(lambda s: scatter_stitch_shard(torch.from_numpy(words[s].view(np.int32)),
                                                   torch.tensor(nbits[s]), group), range(n))
    own = np.stack([g[0].numpy().view(np.uint64) for g in got])
    n_own = np.array([int(g[1]) for g in got])
    np.testing.assert_array_equal(own, np.asarray(want[0]).reshape(n, -1))
    np.testing.assert_array_equal(n_own, np.asarray(want[1]).reshape(-1))
    np.testing.assert_array_equal([int(g[2]) for g in got], nbits)
    assert assemble_scatter(own, n_own, nbits) == stitch_bytes(zip(words, nbits))


def _hooks(xp):
    """The three hooks, each a function of its shard-local inputs, in numpy
    form for either package: xp is jnp or torch."""
    where = jnp.where if xp is jnp else torch.where

    def prev_exchange(vals):
        return (vals[0, :, 0] + 3) & 0xFF

    def rung_exchange(exit_runbits):
        return (exit_runbits + 1) & 3

    def cf_exchange(is_set, set_val):
        return where(is_set, set_val, 0).max(0) if xp is jnp else \
            where(is_set, set_val, 0).amax(0)

    return dict(prev_exchange=prev_exchange, rung_exchange=rung_exchange,
                cf_exchange=cf_exchange)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_encode_best_blocks_hooks_match_qb3_tpu(dtype):
    """encode_best_blocks with its three hooks against qb3_tpu's with the
    same hooks, on one strip whose groups reach every kind: all nine
    outputs equal; and with no hooks the outputs are those of the entry
    state given as arguments."""
    img = kinds_scene(16, 20, 3, dtype, 60)
    nb, tbits = 3, 8 * np.dtype(dtype).itemsize
    cband = tuple(default_cband(nb))
    jhooks = _hooks(jnp)

    def jfn(x):
        zero = jnp.zeros(nb, x.dtype)
        return jbest.encode_best_blocks(x, zero, jnp.zeros(nb, jnp.int32), zero, HILBERT,
                                        cband, **jhooks)

    want = [np.asarray(o) for o in jax.jit(jfn)(jnp.asarray(img))]
    zero = torch.zeros(nb, dtype=torch.int64)
    x = to_carrier(img, "cpu")
    got = tbest.encode_best_blocks(x, zero, zero, zero, HILBERT, cband, tbits, **_hooks(torch))
    assert len(got) == len(want) == 9
    for i, (g, w) in enumerate(zip(got, want)):
        g = g.numpy()
        np.testing.assert_array_equal(g.view(np.uint64) if g.dtype == np.int64
                                      else g.astype(np.uint64), w.astype(np.uint64),
                                      err_msg=f"output {i}")
    # no hooks: the entry state is the arguments'
    th = _hooks(torch)
    vals = tbest.gather_blocks(x, HILBERT, cband, tbits)
    prev = th["prev_exchange"](vals)
    exit_runbits = tbest.block_rungs(tbest.delta_mags(vals, prev, tbits)[0], zero)[3]
    plain = tbest.encode_best_blocks(x, prev, th["rung_exchange"](exit_runbits), got[8][0],
                                     HILBERT, cband, tbits)
    for i in range(9):
        assert torch.equal(plain[i], got[i]), f"output {i}"


def test_best_ic_index_writes_ib():
    """qb3_tpu's rule: a best mode's sharded encode writes the "ib"
    sidecar for any true index, "ic" included, where the single-device
    Encoder writes the best modes' "ic"."""
    img = corpus.natural8(32, 32, 3, seed=136)
    s = tsh.encode_sharded(img, 4, mode=Mode.CF_H, index="ic", devices=cpu(4))
    assert s == jsh.encode_sharded(img, 4, mode=Mode.CF_H, index="ic")
    info = container.parse_headers(s)
    assert info.index_best is not None and info.index_chunked is None
    assert s == qb3_tpu.encode(img, mode=Mode.CF_H, index=True)


def test_sidecar_cutoffs(monkeypatch):
    """A CF past 16 bits writes no "ib" sidecar; 2^31 bits of "ic" spans
    write no "ic" sidecar (patched spans, in both packages); each as
    qb3_tpu decides it."""
    img = corpus.to_type(corpus.natural8(16, 16, 1, seed=16), np.uint32, 65537 * 3)
    s = tsh.encode_sharded(img, 4, mode=Mode.CF_H, index=True, devices=cpu(4))
    assert s == qb3_tpu.encode(img, mode=Mode.CF_H, index=True)
    info = container.parse_headers(s)
    assert info.index_best is None and info.index_chunked is None

    from qb3_tpu.ops import decode_chunked as jdc

    def huge(real):
        def spans(*a):
            sp, entry = real(*a)
            sp = sp.copy()
            sp[0] = 1 << 31
            return sp, entry
        return spans

    monkeypatch.setattr(framing, "chunk_spans", huge(framing.chunk_spans))
    monkeypatch.setattr(jdc, "chunk_spans", huge(jdc.chunk_spans))
    img = corpus.natural8(32, 64, 1, seed=17)
    s = tsh.encode_sharded(img, 4, mode=Mode.FTL, index="ic", devices=cpu(4))
    assert s == jsh.encode_sharded(img, 4, mode=Mode.FTL, index="ic")
    assert container.parse_headers(s).index_chunked is None


# ------------------------------------------------------------ the shard group

def test_shard_group_collectives():
    """ppermute_next shifts by one with zeros at shard 0, all_gather keeps
    shard order on every shard, axis_index / axis_size, and the bytes the
    shards received."""
    n = 5
    group = tsh.ShardGroup(cpu(n))
    tsh.ShardGroup.bytes_moved = 0

    def shard(k):
        x = torch.tensor([10 * k + 1, 10 * k + 2])
        return (group.axis_index(), group.axis_size(), group.ppermute_next(x),
                group.all_gather(x), group.all_gather(torch.tensor(k == 2)))

    out = group.run(shard, list(range(n)))
    for i, (idx, size, prev, gathered, flags) in enumerate(out):
        assert (idx, size) == (i, n)
        assert prev.tolist() == ([0, 0] if i == 0 else [10 * i - 9, 10 * i - 8])
        assert gathered.tolist() == [[10 * k + 1, 10 * k + 2] for k in range(n)]
        assert flags.tolist() == [k == 2 for k in range(n)]
    # (n - 1) ppermutes of 16 bytes, n all-gathers of (n - 1) x 16 and (n - 1) x 1
    assert tsh.ShardGroup.bytes_moved == (n - 1) * 16 + n * (n - 1) * 17


def test_shard_group_stress():
    """16 shards (more than this machine's cores) through 40 collectives
    each with a short switch interval: every shard gets every round's
    values in shard order, and no byte of the shared counter is lost."""
    import sys

    n, rounds = 16, 40
    group = tsh.ShardGroup(cpu(n), timeout=60)
    tsh.ShardGroup.bytes_moved = 0
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        out = group.run(lambda k: [group.all_gather(torch.tensor([k, r])).tolist()
                                   for r in range(rounds)], list(range(n)))
    finally:
        sys.setswitchinterval(interval)
    for got in out:
        assert got == [[[k, r] for k in range(n)] for r in range(rounds)]
    assert tsh.ShardGroup.bytes_moved == rounds * n * (n - 1) * 16


def test_shard_group_raises_and_joins():
    """A shard that raises makes run raise its exception in the caller well
    within the barrier's timeout (the others leave their collective), and
    no shard thread is left running; the group runs again afterwards."""
    group = tsh.ShardGroup(cpu(4), timeout=30)

    def shard(k):
        if k == 2:
            raise ValueError("shard 2 failed")
        return group.all_gather(torch.tensor(k))

    t0 = time.perf_counter()
    with pytest.raises(ValueError, match="shard 2 failed"):
        group.run(shard, list(range(4)))
    assert time.perf_counter() - t0 < 10
    assert not [t for t in threading.enumerate() if t.name.startswith("qb3 shard")]
    out = group.run(lambda k: group.all_gather(torch.tensor(k)), list(range(4)))
    assert [o.tolist() for o in out] == [[0, 1, 2, 3]] * 4


def test_shard_group_barrier_timeout():
    """A shard that never reaches a collective makes the others' wait time
    out: run raises BrokenBarrierError after joining every thread."""
    group = tsh.ShardGroup(cpu(2), timeout=0.5)

    def shard(k):
        if k == 0:
            time.sleep(1.0)
            return None
        return group.all_gather(torch.tensor(k))

    with pytest.raises(threading.BrokenBarrierError):
        group.run(shard, [0, 1])
    assert not [t for t in threading.enumerate() if t.name.startswith("qb3 shard")]


def test_devices_rule(monkeypatch):
    """devices=None means one CUDA device a shard: without them every entry
    point raises before any shard runs, never on the CPU; a list of another
    length than the shards raises."""
    ran = []
    monkeypatch.setattr(tsh.ShardGroup, "run", lambda *a: ran.append(a))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    img = corpus.natural8(32, 16, 1, seed=1)
    stream = qb3_tpu.encode(img, index=True)
    calls = [lambda: tsh.encode_fast_sharded(img, 4),
             lambda: tsh.encode_fast_sharded_scatter(img, 4),
             lambda: tsh.encode_sharded(img, 4),
             lambda: tsh.encode_tiles_sharded(img[None], 1, 4),
             lambda: tsh.decode_fast_sharded(stream, 4),
             lambda: tsh.stitch_streams(np.zeros((4, 2), np.uint32), np.zeros(4, np.int64)),
             lambda: tsh.dryrun_multichip(4)]
    for call in calls:
        with pytest.raises(RuntimeError, match="need 4 devices, have"):
            call()
    with pytest.raises(ValueError, match="3 devices for 4 shards"):
        tsh.encode_sharded(img, 4, devices=cpu(3))
    assert not ran
    assert [d.type for d in tsh.shard_devices(["cuda:0"] * 3, 3)] == ["cuda"] * 3


def test_stitch_streams_matches_qb3_tpu():
    rng = np.random.default_rng(7)
    words = rng.integers(0, 1 << 32, (5, 6), dtype=np.uint64).astype(np.uint32)
    totals = np.array([0, 33, 192, 1, 64], np.int64)
    got, t = tsh.stitch_streams(words, totals, devices=cpu(5))
    want, _ = jsh.stitch_streams(words, totals)
    assert got == want
    np.testing.assert_array_equal(t, totals)


def test_dryrun_multichip():
    tsh.dryrun_multichip(8, cpu(8))
