// K2, the "ic" chunk walk for qb3_tpu_torch, sm_90a.
//
// Replaces qb3_tpu/ops/chunkwalk_pallas.py: chunkwalk8 (_chunkwalk8_kernel).
//
// What it computes: the "ic" sidecar anchors the stream every K blocks with
// a bit offset and the per-band entry rungs.  One chunk's K * NB groups
// decode back to back: codeswitch (dsw), the rung-0 BITS/ZERO flag, 16
// values as the group-context VLC at the band's running rung, and for BASE
// modes the step-bit restore (QB3decode.h:603-723, :285-289).  Output:
// (nchunks, K, NB, 16) u32 mag-sign values, for u8 (ubits 3) and u16
// (ubits 4) streams.
//
// Semantics: those of the JAX package's portable walk
// (qb3_tpu/ops/decode_chunked.py: decode_chunked), bit for bit, including
// on corrupt streams: each group reads NREG words from its clipped base
// word, and a 64-bit window at bit o of that register set reads words
// o >> 5 .. (o >> 5) + 2 (zero past word NREG - 1), or from word NREG - 1
// where o lies outside [0, 32 * NREG), which only a corrupt chunk reaches.
// A word outside the tile's window is read from the stream.
//
// Bound: latency.  Each chunk is a serial walk of K * NB groups, 16 values
// each, a few thousand dependent integer operations a thread; it writes
// K * NB * 64 bytes (1536 at u8 512x512x3, 402 MB at 128 such tiles, 0.12
// ms at the HBM rate).  The single 512x512x3 image has 2048 chunks, far
// fewer threads than the card holds; a batch of 128 tiles fills it.
//
// Design: one block (CTA) per tile of 128 chunks, a thread a chunk.  The
// block stages its tile's window, the R words K3 copied from row wrow[t]
// (at most kMaxWin of them; words past that are read from K3's window in
// device memory), in shared memory with one bulk asynchronous copy on an
// mbarrier (blockpack.cuh's stage).  A group whose NREG register words lie
// in the staged window reads each 64-bit window from three shared-memory
// words by 32-bit indices, with two funnel shifts; only a corrupt chunk's
// group first gathers its words into shared memory by the general rules.
// The first values of a group reuse its codeswitch's window.  The
// accumulator is a native uint64_t, not the TPU's two u32 lanes.
// The band rungs live in shared memory (a byte a band and chunk), not in a
// per-thread array.  Each group's 64 bytes go through a per-warp staging
// area in shared memory (16-byte pieces swizzled against bank conflicts),
// so every store instruction writes 64 contiguous bytes (two whole 32-byte
// sectors) of eight chunks, not 16 bytes of 32 chunks 1.5 KB apart.

#include <cuda_runtime.h>

#include <cstdint>

#include "blockpack.cuh"
#include "vlc.cuh"

#ifndef QB3_PHASE  // cycle counts of ab_phases_decode.py; nothing in the library
#define QB3_PHASE_BEGIN
#define QB3_PHASE(k)
#define QB3_PHASE_END(c)
#endif

namespace {

constexpr int kTile = 128;     // chunks per window tile, a thread each
constexpr int kMaxBands = 256;
constexpr int kMaxWin = 8192;  // window words staged in shared memory (32 KB)
constexpr uint32_t kStageBytes = kTile * 64;  // a group's 64 output bytes a thread

// Dynamic shared memory of a block: the output staging, the rungs (a byte
// a band and chunk, padded to 16 bytes), the staged window.
__host__ __device__ constexpr uint32_t rung_bytes(int NB) {
  return (static_cast<uint32_t>(NB) * kTile + 15) & ~15u;
}

// 64 bits at bit o of a group's NREG register words p[0 .. NREG - 1]
// (shared memory); word indices outside [0, NREG - 1] read as NREG - 1,
// like the JAX select chain's default, and words past NREG - 1 read zero.
template <int NREG>
__device__ __forceinline__ uint64_t window(const uint32_t* p, int32_t o) {
  int wi = o >> 5;
  if (wi < 0 || wi > NREG - 1) wi = NREG - 1;
  const uint32_t a = p[wi];
  const uint32_t b = wi + 1 < NREG ? p[wi + 1 < NREG ? wi + 1 : NREG - 1] : 0u;
  const uint32_t c = wi + 2 < NREG ? p[wi + 2 < NREG ? wi + 2 : NREG - 1] : 0u;
  const int sh = o & 31;
  return __funnelshift_r(a, b, sh) | static_cast<uint64_t>(__funnelshift_r(b, c, sh)) << 32;
}

template <int UBITS>
__global__ void __launch_bounds__(kTile)
chunkwalk_kernel(const uint32_t* __restrict__ words, int64_t n32,
                 const uint32_t* __restrict__ win, const int32_t* __restrict__ wrow, int R,
                 const int32_t* __restrict__ starts, const int32_t* __restrict__ entry,
                 int64_t nchunks, int K, int NB, int apply_step, uint32_t* __restrict__ out) {
  constexpr int NREG = UBITS == 3 ? 7 : 11;  // decode_chunked._NREG
  constexpr int PER = UBITS == 3 ? 6 : 3;    // values per 64-bit window
  constexpr int NMASK = (1 << UBITS) - 1;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t t = blockIdx.x;
  const int64_t c0 = t * kTile;
  // a thread past the last chunk walks it again and stores nothing
  const bool live = c0 + tid < nchunks;
  const int64_t c = live ? c0 + tid : nchunks - 1;
  QB3_PHASE_BEGIN

  uint8_t* rungs = smem + kStageBytes;  // band b of this chunk at rungs[b * kTile + tid]
  for (int b = 0; b < NB; ++b)
    rungs[b * kTile + tid] = static_cast<uint8_t>(entry[c * NB + b] & NMASK);
  const uint32_t* twin = win + t * static_cast<int64_t>(R);
  const int Rs = R < kMaxWin ? R : kMaxWin;
  const qb3::Span sp[1] = {{reinterpret_cast<const unsigned char*>(twin),
                            smem + kStageBytes + rung_bytes(NB), static_cast<uint32_t>(Rs) * 4u,
                            4u}};
  qb3::stage(sp, qb3::smem_addr(&bar));  // its barrier also publishes the rungs
  const uint32_t* staged = reinterpret_cast<const uint32_t*>(sp[0].dst());
  const int64_t wbase = static_cast<int64_t>(wrow[t]) * 128;
  QB3_PHASE(0)

  const int G = K * NB;
  const int64_t row = static_cast<int64_t>(G) * 16;  // words of a chunk's output
  uint4* stage4 = reinterpret_cast<uint4*>(smem) + warp * 128;  // 2 KB a warp
  // a group whose register words leave the staged window gathers them into
  // its lane's 64 bytes of the staging area, idle during the walk
  uint32_t* own = reinterpret_cast<uint32_t*>(stage4 + lane * 4);
  const int64_t cw0 = c0 + 32 * warp;  // the warp's first chunk
  int32_t off = starts[c];
  int b = 0;
  for (int g = 0; g < G; ++g) {
    int64_t base = off >> 5;
    base = base < 0 ? 0 : (base > n32 - NREG ? n32 - NREG : base);
    const int32_t phase = off - static_cast<int32_t>(base << 5);
    const int64_t rel = base - wbase;
    const uint32_t* p = staged + rel;
    if (rel < 0 || rel + NREG > Rs) {
#pragma unroll
      for (int j = 0; j < NREG; ++j) {
        const int64_t r = rel + j;
        own[j] = r >= 0 && r < Rs ? staged[r] : (r >= 0 && r < R ? twin[r] : words[base + j]);
      }
      p = own;
    }

    const uint64_t w0 = window<NREG>(p, phase);
    int cs_len = 1, delta = 0;
    if (w0 & 1ull) delta = qb3::dsw(w0 >> 1, UBITS, &cs_len);
    const int rung = (rungs[b * kTile + tid] + delta) & NMASK;
    rungs[b * kTile + tid] = static_cast<uint8_t>(rung);
    const bool is_group = rung != 0;
    const bool is_bits = !is_group && ((w0 >> cs_len) & 1ull);
    int32_t o = phase + cs_len + (is_group ? 0 : 1);
    // the first values' window is the codeswitch's, shifted: its first 64 -
    // (o - phase) >= 57 bits cover the PER values' <= 54, unless the window
    // clamps (a corrupt chunk)
    uint64_t first = w0 >> (o - phase);
    if (phase < 0 || o >= 32 * NREG) first = window<NREG>(p, o);

    uint32_t vals[16];
#pragma unroll
    for (int v0 = 0; v0 < 16; v0 += PER) {
      const uint64_t w = v0 == 0 ? first : window<NREG>(p, o);
      int shift = 0;
#pragma unroll
      for (int i = v0; i < (v0 + PER < 16 ? v0 + PER : 16); ++i) {
        const uint32_t ww = static_cast<uint32_t>(w >> shift);
        int gl;
        const uint32_t gv = qb3::vlc_group32(ww, rung, &gl);
        vals[i] = is_group ? gv : (is_bits ? (ww & 1u) : 0u);
        shift += is_group ? gl : (is_bits ? 1 : 0);
      }
      o += shift;
    }
    if (apply_step && is_group) qb3::step_restore(vals, rung);
    QB3_PHASE(1)

    // piece q of lane l's 64 bytes at l * 4 + (q ^ ((l >> 1) & 3)): each
    // 8-lane phase of the writes and of the reads touches eight bank quads
#pragma unroll
    for (int q = 0; q < 4; ++q)
      stage4[lane * 4 + (q ^ ((lane >> 1) & 3))] =
          make_uint4(vals[4 * q], vals[4 * q + 1], vals[4 * q + 2], vals[4 * q + 3]);
    __syncwarp();
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int k = lane + 32 * r, src = k >> 2, q = k & 3;
      if (cw0 + src < nchunks)
        reinterpret_cast<uint4*>(out + (cw0 + src) * row + g * 16)[q] =
            stage4[src * 4 + (q ^ ((src >> 1) & 3))];
    }
    __syncwarp();
    QB3_PHASE(2)
    off = static_cast<int32_t>(static_cast<uint32_t>(off) + static_cast<uint32_t>(o - phase));
    b = b + 1 == NB ? 0 : b + 1;
  }
  if (live) {
    QB3_PHASE_END(c)
  }
}

template <int UBITS>
cudaError_t launch(unsigned blocks, uint32_t smem, cudaStream_t stream, const uint32_t* words,
                   int64_t n32, const uint32_t* win, const int32_t* wrow, int R,
                   const int32_t* starts, const int32_t* entry, int64_t nchunks, int K, int NB,
                   int apply_step, uint32_t* out) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        chunkwalk_kernel<UBITS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  chunkwalk_kernel<UBITS><<<blocks, kTile, smem, stream>>>(words, n32, win, wrow, R, starts,
                                                           entry, nchunks, K, NB, apply_step,
                                                           out);
  return cudaSuccess;
}

}  // namespace

// K2.  words (n32,) u32; win (ceil(nchunks / 128), R) u32, 16-byte aligned,
// the tiles' windows from K3, row t from word wrow[t] * 128; starts
// (nchunks,) int32; entry (nchunks, NB) int32; out (nchunks, K, NB, 16) u32,
// 16-byte aligned.
extern "C" int qb3_chunkwalk(const void* words, int64_t n32, const void* win,
                             const void* wrow, int R, const void* starts,
                             const void* entry, int64_t nchunks, int K, int NB,
                             int apply_step, int ubits, void* out, void* stream) {
  if ((ubits != 3 && ubits != 4) || NB < 1 || NB > kMaxBands || K < 1 || R < 1 ||
      n32 < (ubits == 3 ? 7 : 11) || nchunks > (static_cast<int64_t>(kTile) << 31) - kTile)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nchunks > 0) {
    const unsigned blocks = static_cast<unsigned>((nchunks + kTile - 1) / kTile);
    const uint32_t Rs = R < kMaxWin ? R : kMaxWin;
    const uint32_t smem = kStageBytes + rung_bytes(NB) + qb3::region_bytes(Rs * 4);
    const auto cs = static_cast<cudaStream_t>(stream);
    const auto* w = static_cast<const uint32_t*>(words);
    const auto* wn = static_cast<const uint32_t*>(win);
    const auto* wr = static_cast<const int32_t*>(wrow);
    const auto* st = static_cast<const int32_t*>(starts);
    const auto* en = static_cast<const int32_t*>(entry);
    auto* o = static_cast<uint32_t*>(out);
    const cudaError_t err =
        ubits == 3 ? launch<3>(blocks, smem, cs, w, n32, wn, wr, R, st, en, nchunks, K, NB,
                               apply_step, o)
                   : launch<4>(blocks, smem, cs, w, n32, wn, wr, R, st, en, nchunks, K, NB,
                               apply_step, o);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
