"""Edge inputs of the fused "ix" walk (K4) and the "ic" chunk walk (K2),
made with numpy from a seed.

K4 takes its groups in blocks of BLOCK (of several rounds of BLOCK on a
large grid): it scans the codeswitch deltas per band across a block
(segments end where a tile starts), finds each block's carry by a decoupled
look-back over the tile's earlier blocks, 128 at a time, and reads a
group's window from the staged span.  So the inputs that can break it are:
tiles that start inside a block, a tile longer than 129 blocks, a grid of
blocks of several rounds, 1 to 256 bands (more than a block holds), sidecar
lengths that send windows outside the span or the stream, and every element
width with u64's rung-63 long form.  Random words give random codeswitches, rungs and
codes, so every kind and rung occurs.

K2 walks a chunk per thread, a block per tile of BLOCK chunks, from the
tile's window staged in shared memory, with the band rungs in shared
memory.  Its inputs that can break it: 1 to 256 bands, u8 and u16, a last
tile of fewer than BLOCK chunks, and corrupt chunks that start past the
stream (their windows clamp to register word NREG - 1) or outside their
tile's window (read from the stream).

The CPU tests hold the port's twins to qb3_tpu's walks on these inputs; the
card tests hold the kernels to the twins.
"""

import numpy as np

from qb3_tpu_torch.ops.chunkwalk_cuda import ic_walk_params

BLOCK = 128  # groups a K4 block walks, chunks a K2 block walks
GMAX = {8: 150, 16: 280, 32: 540, 64: 1056}  # longest valid group, bits

# K4 cases: name -> (tbits, bands, blocks a tile, tiles, apply_step)
K4_CASES = {
    "u8-tiles-inside-blocks": (8, 3, 30, 7, False),    # 90 groups a tile
    "u16-long-tile": (16, 1, 17000, 1, True),          # 133 blocks a tile
    "u32-8-bands": (32, 8, 50, 3, False),
    "u8-129-bands": (8, 129, 3, 2, True),              # more bands than a block's groups
    "u64-256-bands": (64, 256, 2, 2, False),
    "u64-rung63": (64, 3, 300, 1, True),
    "u16-damaged-span": (16, 3, 200, 2, False),        # windows leave the span and the stream
    # 540000 groups and more: the kernel walks 2 rounds of 128 groups a block
    "u8-rounds": (8, 3, 60000, 3, True),
    "u16-rounds-1-band": (16, 1, 530000, 1, False),
}
# the twin knows no rounds: on the CPU only its size would grow
CARD_ONLY = {"u8-rounds", "u16-rounds-1-band"}


def k4_case(name: str, seed: int = 0):
    """-> (words32 int32 (n32,), glens int32 (tiles * groups,), tbits,
    nbands, nblocks, ntiles, tile_words32, apply_step): random stream words
    in decode_tiles' flat tile layout and random sidecar lengths."""
    tbits, nb, nblocks, ntiles, step = K4_CASES[name]
    rng = np.random.default_rng(seed + len(name))
    per_tile = nblocks * nb
    glens = rng.integers(1, GMAX[tbits] + 1, (ntiles, per_tile)).astype(np.int64)
    tw32 = int(glens.sum(1).max()) // 32 + 8
    if name == "u16-damaged-span":
        # every 50th length far past the format's maximum: a window then starts
        # past the block's staged span, and the tile's last ones past the stream
        glens[:, 7::50] = rng.integers(20000, 65536, glens[:, 7::50].shape)
    words = rng.integers(0, 1 << 32, ntiles * tw32, dtype=np.uint64).astype(np.uint32)
    return (words.view(np.int32), glens.reshape(-1).astype(np.int32), tbits, nb, nblocks,
            ntiles, tw32, step)


# K2 cases: name -> (ubits, bands, blocks a chunk, chunks, apply_step)
K2_CASES = {
    "u8-1-band": (3, 1, 16, 300, False),       # last tile: 44 chunks
    "u16-3-bands": (4, 3, 4, 200, True),
    "u8-8-bands": (3, 8, 2, 256, True),
    "u16-256-bands": (4, 256, 1, 130, False),  # last tile: 2 chunks
    "u8-corrupt": (3, 2, 4, 400, True),        # starts past the stream, and in no window
    "u16-corrupt": (4, 2, 4, 400, False),
}


def k2_case(name: str, seed: int = 0):
    """-> (words32 int32 (n32,), starts int32 (nchunks,), entry int32
    (nchunks, NB), ubits, NB, K, apply_step, maxw, R): random words, sorted
    chunk starts ~ a chunk's length apart and random entry rungs; maxw and R
    the tiles' window words (ops.chunkwalk_cuda.ic_walk_params' rule, or a
    window narrower than the walk for the corrupt cases)."""
    ubits, nb, k, nchunks, step = K2_CASES[name]
    rng = np.random.default_rng(seed + len(name))
    chunk_bits = k * nb * (100 if ubits == 3 else 180)  # random codes: ~6-11 bits a value
    starts = np.cumsum(rng.integers(chunk_bits // 2, chunk_bits, nchunks)) - chunk_bits // 2
    n32 = int(starts[-1]) // 32 + k * nb * 16 + 64
    entry = rng.integers(0, 256, (nchunks, nb)).astype(np.int32)
    if "corrupt" in name:
        # a fifth of the chunks start past the stream's end; the window covers
        # only the first few chunks of each tile
        past = rng.random(nchunks) < 0.2
        starts = np.where(past, 32 * n32 + rng.integers(0, 4000, nchunks), starts)
        starts = np.sort(starts)
        maxw, R = 16, 256
    else:
        # random codes run up to ~3x the starts' spacing
        maxw, R = ic_walk_params(starts, 4 * np.diff(np.append(starts, starts[-1] + chunk_bits)))
    words = rng.integers(0, 1 << 32, n32, dtype=np.uint64).astype(np.uint32)
    return (words.view(np.int32), starts.astype(np.int32), entry, ubits, nb, k, step, maxw, R)
