// K4 (wavefront_fused) for qb3_tpu_torch, sm_90a.
//
// Replaces qb3_tpu/ops/fusedwin_pallas.py: wavefront_fused (_fused_kernel,
// with _window_build, _seg_prefix and _dsw_arith32).
//
// What it computes: the "ix" sidecar decode.  The sidecar gives every group
// its bit length, so the wrapper hands the kernel each group's start bit
// goff (an exclusive prefix sum per tile).  Per group the kernel reads its
// register window, parses the codeswitch (QB3decode.h:603-618), runs the
// band rung chain (a prefix sum of the codeswitch deltas per band, modulo
// 2^ubits, restarting at every tile of a flat batch), and walks the 16
// values (group-context VLC at the rung; u64 with the rung-63 65-bit form),
// with the BASE-mode step restore when asked.  Output: (ngroups, 16) u64
// mag-sign values and the (ngroups,) rungs.  With nbands == 0 the caller
// gives off / rung / kind instead and the kernel only walks.
//
// Semantics: those of decode_indexed_narrow(use_pallas=False), the JAX
// package's XLA walk, bit for bit, damaged streams included.  A group reads
// NREG words from word goff >> 5, with JAX's gather rules (a negative index
// counts from the end, indices clamp into the stream), window words past
// NREG - 1 through the XLA select chains (a 64-bit window at word index
// wi >= NREG - 1 starts at word NREG - 1; the u8 accumulator reads zero
// there).  The TPU kernel's 8-word-aligned window reads zero past its end,
// so on a sidecar whose lengths exceed the format's maximum it can differ.
//
// Bound: a group is ~16 dependent VLC decodes; it moves its window (~20-150
// bytes, shared with its neighbours) and 128 output bytes, so at 128 u8
// tiles the int64 output alone (805 MB) takes 0.24 ms at the HBM rate.
//
// Design: one thread per group, 128 groups a round; a block (CTA) walks G
// rounds, 2 where the grid is large (see kRounds), else 1.  A block, in one
// launch:
//   1. takes its index from an atomic ticket in start order and stages
//      each round's stream span, R words from the round's first group's
//      base word, in shared memory by a bulk asynchronous copy on a barrier
//      of its own (blockpack.cuh's stage_issue; the unaligned edges through
//      the threads), all issued before any is waited for;
//   2. parses each group's codeswitch from the span;
//   3. scans the codeswitch deltas per band (stride nbands) across the block:
//      shuffles inside each warp, then each thread adds the last element of
//      its band in each earlier warp; segments end at tile starts;
//   4. publishes its bands' sums in state words of ten 6-bit fields (a
//      band's sum mod 64; kBandsPerWord bands a word), and a warp a word
//      finds the block's carry with blockpack.cuh's decoupled look-back, 128
//      predecessors at a time (four loads a lane), combining the fields by a
//      per-field add;
//   5. round by round, walks its groups: a
//      window wholly inside the span is read from shared memory by 32-bit
//      indices, only a damaged sidecar's window takes the gather rules above
//      and reads the stream;
//   6. stages each warp's 32 groups (4 KB, contiguous in the output) in
//      shared memory in 16-byte pieces, swizzled so that neither the writes
//      of a group's 128 bytes nor the reads conflict, and stores them with
//      16-byte stores on consecutive addresses (512 bytes an instruction).
//      A bulk store would need the plain layout, whose writes a thread's
//      128 bytes at a time conflict eight ways.
// The wrapper's call is one memset of the ticket and state words (in the
// entry point) and one launch.  The TPU's planar view, bf16 byte planes and
// one-hot MXU window build are a gather and are gone.

#include <cuda_runtime.h>

#include <cstdint>

#include "blockpack.cuh"
#include "vlc.cuh"

#ifndef QB3_STAMP  // time stamps of ab_phases_decode.py; nothing in the library
#define QB3_ENTRY
#define QB3_STAMP(k)
#endif

namespace {

constexpr int kThreads = 128;  // threads a block, groups a round (ops/fusedwin_cuda.FUSED_G)
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBands = 256;
constexpr int kMaxR = 8192;  // staged words a round: 32 KB of shared memory (FUSED_MAX_R)
constexpr int kBandsPerWord = 10;  // 6-bit band sums in a state word's 62 value bits
constexpr uint32_t kOutBytes = kThreads * 16 * 8;  // a round's output, staged

// Rounds a block walks: G = kRounds where the grid holds at least
// kRoundsFrom blocks of kThreads groups and their spans fit, else 1.  More
// groups a block amortise its look-back, whose wait sets the pace where many
// blocks wait on their predecessors at once; a small grid keeps one round
// a block, so its blocks spread over the card.  2 was the fastest of 1, 2,
// 4 and 8 at 128 u8 tiles and u64 x 8 on the H100, 4 in turns with 2
// (ab_phases_decode.py --set kRounds=, PERF.md).
constexpr int kRounds = 2;
constexpr int64_t kRoundsFrom = 4096;
constexpr uint32_t kRoundsMaxSpans = 24 * 1024;  // shared memory of the rounds' spans

// Look-back values of K4: ten 6-bit fields, each a band's sum mod 64 (the
// rung arithmetic is mod 2^ubits, ubits <= 6).  A per-field add: the low five
// bits of each field add with their carry into the (cleared) top bit, which
// then takes the top bits' sum mod 2.
struct BandSums {
  static constexpr uint64_t kTop = 0x820820820820820ull;  // bit 5 of every field
  __device__ static uint64_t combine(uint64_t a, uint64_t b) {
    return ((a & ~kTop) + (b & ~kTop)) ^ ((a ^ b) & kTop);
  }
};

// A group's register window whose words all lie in the staged span: word j
// of the window at w[j], zero outside [0, nreg - 1].
struct SpanWindow {
  const uint32_t* w;
  int nreg;
  __device__ uint32_t reg(int j) const {
    return static_cast<unsigned>(j) < static_cast<unsigned>(nreg) ? w[j] : 0u;
  }
};

// A window that leaves the span (a damaged sidecar): words base .. base +
// nreg - 1 of the stream with JAX's gather rules, through the span where
// they lie in it.
struct StreamWindow {
  const uint32_t* words;
  int64_t n32;
  const uint32_t* span;  // stream words [lo, hi)
  int64_t lo, hi, base;
  int nreg;
  __device__ uint32_t reg(int j) const {
    if (static_cast<unsigned>(j) >= static_cast<unsigned>(nreg)) return 0u;
    int64_t i = base + j;
    if (i < 0) i += n32;
    i = i < 0 ? 0 : (i >= n32 ? n32 - 1 : i);
    return (i >= lo && i < hi) ? span[i - lo] : __ldg(words + i);
  }
};

// 64 window bits from bit o; word indices outside [0, nreg - 2] read from
// word nreg - 1 on, as the XLA select chain's default.
template <class W>
__device__ __forceinline__ uint64_t bits64(const W& W_, int o) {
  int wi = o >> 5;
  const int sh = o & 31;
  if (wi < 0 || wi > W_.nreg - 1) wi = W_.nreg - 1;
  const uint32_t a = W_.reg(wi), b = W_.reg(wi + 1), c = W_.reg(wi + 2);
  return __funnelshift_r(a, b, sh) | static_cast<uint64_t>(__funnelshift_r(b, c, sh)) << 32;
}

// The 16-value walk of one group from value bit `off` of its window.
template <int TBITS, class W>
__device__ __forceinline__ void walk(const W& W_, int off, int rung, int kind,
                                     uint64_t (&vals)[16]) {
  const bool isg = kind == 1, isb = kind == 2;
  if (TBITS == 8) {
    // u64 accumulator refilled a word at a time: a 3-value step uses <= 27
    // bits, less than the 32-bit refill
    const int sh = off & 31;
    int k = off >> 5;
    uint64_t acc =
        (static_cast<uint64_t>(W_.reg(k)) | static_cast<uint64_t>(W_.reg(k + 1)) << 32) >> sh;
    int navail = 64 - sh;
    k += 2;
#pragma unroll
    for (int v0 = 0; v0 < 16; v0 += 3) {
      int shift = 0;
#pragma unroll
      for (int i = v0; i < (v0 + 3 < 16 ? v0 + 3 : 16); ++i) {
        const uint32_t ww = static_cast<uint32_t>(acc >> shift);
        int gl;
        const uint32_t gv = qb3::vlc_group32(ww, rung, &gl);
        vals[i] = isg ? gv : (isb ? (ww & 1u) : 0u);
        shift += isg ? gl : (isb ? 1 : 0);
      }
      acc >>= shift;
      navail -= shift;
      if (navail < 27) {
        acc |= static_cast<uint64_t>(W_.reg(k)) << navail;
        navail += 32;
        ++k;
      }
    }
  } else if (TBITS == 16) {
    // one 64-bit window per 3 values (codes of <= 17 bits)
#pragma unroll
    for (int v0 = 0; v0 < 16; v0 += 3) {
      const uint64_t w = bits64(W_, off);
      int shift = 0;
#pragma unroll
      for (int i = v0; i < (v0 + 3 < 16 ? v0 + 3 : 16); ++i) {
        const uint32_t ww = static_cast<uint32_t>(w >> shift);
        int gl;
        const uint32_t gv = qb3::vlc_group32(ww, rung, &gl);
        vals[i] = isg ? gv : (isb ? (ww & 1u) : 0u);
        shift += isg ? gl : (isb ? 1 : 0);
      }
      off += shift;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const uint64_t w = bits64(W_, off);
      int gl;
      uint64_t gv = qb3::vlc64(w, rung, &gl);
      // rung-63 long form: the stream bit past the 64-bit window is value bit 62
      if (TBITS == 64 && gl == 65) gv |= (bits64(W_, off + 64) & 1ull) << 62;
      vals[i] = isg ? gv : (isb ? (w & 1ull) : 0ull);
      off += isg ? gl : (isb ? 1 : 0);
    }
  }
}

// The codeswitch at window bit off0: its first 64 bits, length and delta.
template <int UBITS, class W>
__device__ __forceinline__ uint64_t parse(const W& W_, int off0, int* cs_len, int* delta) {
  const uint64_t w0 = bits64(W_, off0);
  *cs_len = 1;
  *delta = (w0 & 1ull) ? qb3::dsw(w0 >> 1, UBITS, cs_len) : 0;
  return w0;
}

template <int TBITS, bool PARSE, int G>
__global__ void __launch_bounds__(kThreads)
fused_kernel(const uint32_t* __restrict__ words, int64_t n32, const int32_t* __restrict__ goff,
             int64_t ngroups, int nreg, int R, int nbands, int64_t per_tile, int apply_step,
             const int32_t* __restrict__ off_in, const int32_t* __restrict__ rung_in,
             const int32_t* __restrict__ kind_in, uint64_t* __restrict__ out,
             int32_t* __restrict__ rung_out, uint64_t* state, int* ticket) {
  constexpr int UBITS = TBITS == 8 ? 3 : TBITS == 16 ? 4 : TBITS == 32 ? 5 : 6;
  constexpr int kGroups = kThreads * G;  // a block's groups: G rounds of kThreads
  extern __shared__ __align__(128) unsigned char smem[];  // output staging, then G spans
  __shared__ __align__(8) uint64_t bar[G];
  __shared__ int64_t s_blk;
  __shared__ int s_x[kGroups];        // band prefix sums over the block
  __shared__ uint8_t s_cs[kGroups];   // codeswitch length | the rung-0 flag bit << 4
  __shared__ int s_carry[kMaxBands];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  QB3_ENTRY
  int64_t blk = blockIdx.x;
  if (PARSE) {
    // block index in start order: the look-back waits only on running blocks
    if (tid == 0) s_blk = atomicAdd(ticket, 1);
    __syncthreads();
    blk = s_blk;
    QB3_STAMP(1)
  }
  const int64_t g0 = blk * kGroups;
  const uint32_t region = qb3::region_bytes(static_cast<uint32_t>(R) * 4);
  // round i's span: stream words [lo, hi) of R from its first group's base
  // word, rounded down to 16 bytes (empty for a round past the last group),
  // at smem + kOutBytes + i * region
  auto span_of = [&](int i, int64_t* lo, int64_t* hi) {
    const int64_t gi = g0 + kThreads * i;
    const int64_t wbase =
        gi < ngroups ? static_cast<int64_t>(goff[gi] >> 5) & ~static_cast<int64_t>(3) : 0;
    *lo = wbase < 0 ? 0 : wbase;
    const int64_t h = gi < ngroups ? (wbase + R < n32 ? wbase + R : n32) : 0;
    *hi = h < *lo ? *lo : h;
  };
#pragma unroll
  for (int i = 0; i < G; ++i) {
    int64_t lo, hi;
    span_of(i, &lo, &hi);
    const qb3::Span sp[1] = {{reinterpret_cast<const unsigned char*>(words + lo),
                              smem + kOutBytes + i * region, static_cast<uint32_t>(hi - lo) * 4u,
                              4u}};
    qb3::stage_issue(sp, qb3::smem_addr(&bar[i]));
  }
  QB3_STAMP(2)

  __syncthreads();  // the barriers' init, before any thread waits

  // the tile of the block's first group starts at tile0, the next at tile1;
  // tile_start(g) without a 64-bit division where no tile starts in the block
  const int64_t tile0 = PARSE ? g0 / per_tile * per_tile : 0, tile1 = tile0 + per_tile;
  const uint32_t pt32 = per_tile < (1 << 30) ? static_cast<uint32_t>(per_tile) : (1u << 30);
  auto tile_start = [&](int64_t g) {
    return g < tile1 ? tile0 : tile1 + static_cast<uint32_t>(g - tile1) / pt32 * per_tile;
  };
  // ceil(n / nbands) = (n + nbands - 1) * inv >> 24, exact for n + nbands < 2^15
  const uint64_t inv = PARSE ? ((1u << 24) + nbands - 1) / nbands : 0;

  if (PARSE) {
    // the codeswitches, from the spans
    int x[G];
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const int t = kThreads * i + tid;
      const int64_t g = g0 + t;
      const bool live = g < ngroups;
      const int32_t gofs = goff[live ? g : g0];
      const int64_t base = gofs >> 5;
      int64_t lo, hi;
      span_of(i, &lo, &hi);
      const uint32_t* span = reinterpret_cast<const uint32_t*>(smem + kOutBytes + i * region);
      qb3::mbar_wait(qb3::smem_addr(&bar[i]), 0);
      int cs_len, delta;
      const uint64_t w0 =
          base >= lo && base + nreg <= hi
              ? parse<UBITS>(SpanWindow{span + (base - lo), nreg}, gofs & 31, &cs_len, &delta)
              : parse<UBITS>(StreamWindow{words, n32, span, lo, hi, base, nreg}, gofs & 31,
                             &cs_len, &delta);
      s_cs[t] = static_cast<uint8_t>(cs_len | static_cast<int>((w0 >> cs_len) & 1ull) << 4);
      x[i] = live ? delta : 0;
    }
    QB3_STAMP(3)

    // band prefix sums over the block, stride nbands; a segment ends where a
    // tile starts.  Inside each warp by shuffles, then each element adds the
    // last element of its band in each earlier warp-sized chunk.  (A second
    // level over rounds, fewer additions but more registers, was slower.)
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const int t = kThreads * i + tid;
      const int64_t g = g0 + t, tstart = tile_start(g);
      for (int d = nbands; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x[i], d);
        if (lane >= d && g - d >= tstart) x[i] += y;
      }
      s_x[t] = x[i];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const int t = kThreads * i + tid;
      const int64_t tstart = tile_start(g0 + t);
      for (int w = 0; w < (t >> 5); ++w) {
        const int top = 32 * w + 31;  // the last element of this band in chunk w:
        const uint64_t q = (static_cast<uint64_t>(t - top + nbands - 1) * inv) >> 24;
        const int j = t - static_cast<int>(q) * nbands;
        if (j >= 32 * w && g0 + j >= tstart) x[i] += s_x[j];
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < G; ++i) s_x[kThreads * i + tid] = x[i];
    __syncthreads();
    QB3_STAMP(4)

    // the block's last segment [lo_seg, last] and each band's sum over it,
    // ten bands a state word
    const int64_t last = (g0 + kGroups < ngroups ? g0 + kGroups : ngroups) - 1;
    const int64_t tlast = (last / per_tile) * per_tile;
    const bool closed = tlast >= g0;  // the segment starts here: its sums are prefixes
    const int64_t lo_seg = closed ? tlast : g0;
    const int nwords = (nbands + kBandsPerWord - 1) / kBandsPerWord;
    auto fields = [&](int p) {
      uint64_t f = 0;
      for (int k = 0; k < kBandsPerWord && p * kBandsPerWord + k < nbands; ++k) {
        const int b = p * kBandsPerWord + k;
        const int64_t il = last - ((last % nbands) - b + nbands) % nbands;
        if (il >= lo_seg) f |= static_cast<uint64_t>(s_x[il - g0] & 63) << (6 * k);
      }
      return f;
    };
    uint64_t* mine = state + blk * nwords;
    if (tid < nwords)
      qb3::store_relaxed64(mine + tid, (closed ? qb3::kPrefix : qb3::kAgg) | fields(tid));
    const bool needs_carry = g0 != tile0;
    const int64_t first = tile0 / kGroups;  // the block of the tile's start
    for (int p = warp; p < nwords; p += kWarps) {
      uint64_t carry = 0;
      if (needs_carry) {
        carry = qb3::lookback<BandSums, 4>(state + p, blk, first, nwords);
        if (!closed && lane == 0)
          qb3::store_relaxed64(mine + p, qb3::kPrefix | BandSums::combine(carry, fields(p)));
      }
      if (lane < kBandsPerWord && p * kBandsPerWord + lane < nbands)
        s_carry[p * kBandsPerWord + lane] = static_cast<int>(carry >> (6 * lane)) & 63;
    }
    QB3_STAMP(5)
    __syncthreads();  // the carries
  }

  // the rounds: walk kThreads groups, then store them, a warp's 32 groups
  // (4 KB, contiguous in the output) through shared memory: piece q of lane
  // l's group at l * 8 + (q ^ (l & 7)), so each 8-lane phase of a write or a
  // read touches eight different bank quads
  uint4* st = reinterpret_cast<uint4*>(smem) + warp * 256;
  const int b0 = PARSE ? static_cast<int>(g0 % nbands) : 0;
  for (int i = 0; i < G; ++i) {
    const int64_t gi = g0 + kThreads * i;
    if (gi >= ngroups) break;
    const int t = kThreads * i + tid;
    const int64_t g = gi + tid;
    const bool live = g < ngroups;
    const int32_t gofs = goff[live ? g : gi];
    const int64_t base = gofs >> 5;
    int64_t lo, hi;
    span_of(i, &lo, &hi);
    const uint32_t* span = reinterpret_cast<const uint32_t*>(smem + kOutBytes + i * region);
    const bool fast = base >= lo && base + nreg <= hi;
    int off, rung, kind;
    if (PARSE) {
      // the band of group g: (g0 + t) mod nbands
      const int bt = b0 + t;
      const int band = bt - static_cast<int>((static_cast<uint64_t>(bt) * inv) >> 24) * nbands;
      rung = (s_x[t] + (g < tile1 ? s_carry[band] : 0)) & ((1 << UBITS) - 1);
      const bool rung0 = rung == 0;
      const int cs = s_cs[t];
      kind = rung0 ? ((cs >> 4) ? 2 : 0) : 1;
      off = (gofs & 31) + (cs & 15) + (rung0 ? 1 : 0);
      if (live) rung_out[g] = rung;
    } else {
      off = live ? off_in[g] : 0;
      rung = live ? rung_in[g] : 0;
      kind = live ? kind_in[g] : 0;
    }
    qb3::mbar_wait(qb3::smem_addr(&bar[i]), 0);

    uint64_t vals[16];
    if (fast)
      walk<TBITS>(SpanWindow{span + (base - lo), nreg}, off, rung, kind, vals);
    else
      walk<TBITS>(StreamWindow{words, n32, span, lo, hi, base, nreg}, off, rung, kind, vals);
    if (apply_step && kind == 1 && rung >= 1) qb3::step_restore(vals, rung);
    QB3_STAMP(6)

#pragma unroll
    for (int q = 0; q < 8; ++q)
      st[lane * 8 + (q ^ (lane & 7))] =
          make_uint4(static_cast<uint32_t>(vals[2 * q]), static_cast<uint32_t>(vals[2 * q] >> 32),
                     static_cast<uint32_t>(vals[2 * q + 1]),
                     static_cast<uint32_t>(vals[2 * q + 1] >> 32));
    __syncwarp();
    const int64_t gw0 = gi + 32 * warp;
    const int64_t nlive = ngroups - gw0;  // groups of the warp that exist, if < 32
    uint4* dst = reinterpret_cast<uint4*>(out + gw0 * 16);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int k = lane + 32 * r, gl = k >> 3;
      if (gl < nlive) dst[k] = st[gl * 8 + ((k & 7) ^ (gl & 7))];
    }
    __syncwarp();
    QB3_STAMP(7)
  }
}


template <bool PARSE, int G>
cudaError_t launch(int tbits, unsigned blocks, uint32_t smem, cudaStream_t stream,
                   const uint32_t* words, int64_t n32, const int32_t* goff, int64_t ngroups,
                   int nreg, int R, int nbands, int64_t per_tile, int apply_step,
                   const int32_t* off, const int32_t* rung, const int32_t* kind, uint64_t* out,
                   int32_t* rung_out, uint64_t* state, int* ticket) {
  auto kern = tbits == 8    ? fused_kernel<8, PARSE, G>
              : tbits == 16 ? fused_kernel<16, PARSE, G>
              : tbits == 32 ? fused_kernel<32, PARSE, G>
                            : fused_kernel<64, PARSE, G>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kern<<<blocks, kThreads, smem, stream>>>(words, n32, goff, ngroups, nreg, R, nbands, per_tile,
                                           apply_step, off, rung, kind, out, rung_out, state,
                                           ticket);
  return cudaSuccess;
}

}  // namespace

// K4.  words (n32,) u32, 16-byte aligned; goff (ngroups,) int32 group start
// bits; R staged words per block (a multiple of 4); nbands > 0: parse in the
// kernel, per_tile groups per independent stream, rung_out (ngroups,) int32,
// scratch 8 * (1 + ceil(ngroups / 128) * ceil(nbands / 10)) bytes, 8-byte
// aligned, which the entry point zeroes: the look-back's ticket and state
// words; nbands == 0: off / rung / kind (ngroups,) int32 from the caller.
// out (ngroups, 16) u64, 16-byte aligned.
extern "C" int qb3_wavefront_fused(const void* words, int64_t n32, const void* goff,
                                   int64_t ngroups, int nreg, int R, int tbits, int nbands,
                                   int64_t per_tile, int apply_step, const void* off,
                                   const void* rung, const void* kind, void* out,
                                   void* rung_out, void* scratch, void* stream) {
  if (n32 < 1 || nreg < 1 || R < 4 || R % 4 || R > kMaxR || nbands < 0 ||
      nbands > kMaxBands || (tbits != 8 && tbits != 16 && tbits != 32 && tbits != 64) ||
      (nbands > 0 && (per_tile < 1 || per_tile % nbands || ngroups % per_tile)) ||
      ngroups > (static_cast<int64_t>(kThreads) << 31) - kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  if (ngroups > 0) {
    const int64_t blocks1 = (ngroups + kThreads - 1) / kThreads;
    const uint32_t region = qb3::region_bytes(static_cast<uint32_t>(R) * 4);
    const auto* w = static_cast<const uint32_t*>(words);
    const auto* go = static_cast<const int32_t*>(goff);
    auto* o = static_cast<uint64_t*>(out);
    const auto cs = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (nbands > 0) {
      const bool rounds = blocks1 >= kRoundsFrom && kRounds * region <= kRoundsMaxSpans;
      const int64_t blocks = rounds ? (blocks1 + kRounds - 1) / kRounds : blocks1;
      const int64_t nwords = (nbands + kBandsPerWord - 1) / kBandsPerWord;
      auto* ticket = static_cast<int*>(scratch);
      auto* state = reinterpret_cast<uint64_t*>(static_cast<char*>(scratch) + 8);
      auto* ro = static_cast<int32_t*>(rung_out);
      err = cudaMemsetAsync(scratch, 0, static_cast<size_t>(8 * (1 + blocks * nwords)), cs);
      if (err == cudaSuccess && rounds)
        err = launch<true, kRounds>(tbits, static_cast<unsigned>(blocks),
                                    kOutBytes + kRounds * region, cs, w, n32, go, ngroups, nreg, R,
                                    nbands, per_tile, apply_step, nullptr, nullptr, nullptr, o,
                                    ro, state, ticket);
      else if (err == cudaSuccess)
        err = launch<true, 1>(tbits, static_cast<unsigned>(blocks), kOutBytes + region, cs, w,
                              n32, go, ngroups, nreg, R, nbands, per_tile, apply_step, nullptr,
                              nullptr, nullptr, o, ro, state, ticket);
    } else {
      err = launch<false, 1>(tbits, static_cast<unsigned>(blocks1), kOutBytes + region, cs, w,
                             n32, go, ngroups, nreg, R, 0, 1, apply_step,
                             static_cast<const int32_t*>(off), static_cast<const int32_t*>(rung),
                             static_cast<const int32_t*>(kind), o, nullptr, nullptr, nullptr);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
