// K5a (wavefront8) and K5b (wavefront_wide) for qb3_tpu_torch, sm_90a.
//
// Replaces qb3_tpu/ops/wavefront_pallas.py: wavefront8 (_wavefront8_kernel)
// and wavefront_wide (_wavefront_wide_kernel), and, for the best-mode kinds,
// the XLA group decode that qb3_tpu runs after its serial walk
// (decode_groups_fused for u8/u16, decode_groups for u32/u64, in
// qb3_tpu/ops/decode.py).
//
// What they compute: the 16-value walk of one group from its register
// window.  The caller gathered each group's NREG stream words (regs, base =
// first value bit >> 5) and parsed its codeswitch, so a group arrives with
// `off`, the bit of its first value inside the window, its rung, its kind
// and, for CF and CF0 groups, its common factor cf.  Kinds (ops/decode.py
// K5_KIND): 0 all zero, 1 group-coded, 2 literal bits, 3 CF (group-coded,
// then the step restore and the multiply-back by cf), 4 CF0 (literal bits,
// each set one -> the mag-sign of -cf), 5 IDX (16 rung-2 index codes
// without the swap, then max index + 1 <= 8 uniques in the single-value
// context at the rung, each value taken from its unique); any other kind
// decodes as zero.  Group values are the group-context VLC at the rung
// (QB3decode.h:603-723); u64 includes the rung-63 65-bit long form.
// Output: (ngroups, 16) mag-sign values, u32 for K5a (u8 streams), u64 for
// K5b (u16 / u32 / u64 streams); CF and CF0 values are masked to the type
// for u8 / u16 and wrap at 64 bits for u32 / u64, as qb3_tpu's decodes do.
// The BASE-mode step restore of kind-1 groups stays with the caller; a CF
// group's restore must precede its multiply, so it runs here.
//
// Semantics: on kinds 0-2, those of the TPU kernels on any input in their
// domain (off in [0, 64), rung below the type's bit width): window words
// past NREG (and before word 0) read as zero, K5a keeps a 64-bit
// accumulator refilled a word at a time (the uniques continue in it), K5b
// reads each value and each unique from the 64-bit window at its bit (the
// u16 uniques from its low 32 bits; the u64 rung-63 65th bit from the third
// word).  On the walk's groups the window holds the whole group from any
// bit phase (ops/decode._NREG_IX), so no value reads past it.
//
// Bound: latency and the load/store units.  A thread does ~16-24 dependent
// VLC decodes (tens of integer operations each) and moves NREG * 4 + 16 *
// (4 or 8) bytes; at the smoke's shapes (49152-131072 groups) every group
// is resident at once, so the time is the block's staging plus one
// group's dependent chain.
//
// Design: one block (CTA) per kThreads consecutive groups, a thread a
// group.  The block's window rows are one contiguous span of regs
// (kThreads * NREG words), staged in shared memory by one bulk asynchronous
// copy on an mbarrier (blockpack.cuh's stage_issue; an unaligned head or
// tail through the threads) while the threads read their off, rung, kind
// (and cf) with coalesced loads.  The walk then reads only shared memory,
// row-major as the copy lands (a bulk copy cannot transpose; a word-major
// layout would need the threads to copy it); and every window read is
// issued ahead of the decodes that precede its use: K5a reads the word its
// next refill may take at the start of each 3-value step, K5b keeps the
// 96-bit window of three words (the 64 bits at the value's bit and the
// 65th) and reads the words that the value may advance it by before
// decoding it (1 for u16, 2 for u32 and u64, where a third is rare and read
// again), so a refill is a register move, not a load that waits on the
// previous value's length.  The 16 values leave through shared memory:
// each warp writes its 32 groups' values in 16-byte pieces, swizzled so
// that neither the writes nor the reads conflict, and stores them with
// 16-byte stores on consecutive addresses (512 bytes an instruction), the
// whole lines of the warp's contiguous 2 or 4 KB of output; a bulk store
// would need the plain layout, whose 16-byte writes conflict 4 (K5a) or 8
// (K5b) ways.  Every kind decodes its 16 codes in one loop (an IDX group's
// index codes are the group code at rung 2 without its swap), so a warp
// that mixes kinds decodes them once, and only IDX groups branch off for
// their uniques; CF / CF0 groups read cf only where the caller passed it.
// Block shape: 128 threads, a group each; 64 timed the same and 256 slower
// at 49152-131072 groups, and blocks that walk several rounds with double-
// buffered rows, per-warp bulk copies and thread-staged rows were slower
// (ab_wavefront.py, PERF.md).  Measured on an H100 80GB HBM3 at 700 W
// (ab_wavefront.py, device time from the profiler): 0.0058-0.0087 ms at
// 65536-131072 u16 groups and 0.0033 at a 49152-group u8 walk, against
// 0.0136-0.0240 and 0.0040 for the design it replaces, which read each
// window word from device memory at the point of use.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "blockpack.cuh"
#include "vlc.cuh"

#ifndef QB3_PHASE  // cycle counts of ab_phases_decode.py; nothing in the library
#define QB3_PHASE_BEGIN
#define QB3_PHASE(k)
#define QB3_PHASE_WAIT(v)
#define QB3_PHASE_END(c)
#endif

namespace {

constexpr int kThreads = 128;  // threads a block, a group each
constexpr int kMaxNreg = 384;  // window words a group: 192 KB of rows a block
// K5 kind codes (ops/decode.py K5_KIND)
constexpr int kZero = 0, kGroup = 1, kBits = 2, kCf = 3, kCf0 = 4, kIdx = 5;

// A group's window row in shared memory: word j, zero outside [0, nreg).
struct Row {
  const uint32_t* w;
  int nreg;
  __device__ __forceinline__ uint32_t operator[](int j) const {
    return static_cast<unsigned>(j) < static_cast<unsigned>(nreg) ? w[j] : 0u;
  }
};

// CF multiply-back (after the step restore) and CF0 expansion of one
// group's values, masked to `mask` (all ones for u32 / u64).
template <typename T>
__device__ __forceinline__ void apply_cf(T (&vals)[16], int kind, int rung, uint64_t cf,
                                         uint64_t mask) {
  if (kind == kCf) {
    if (rung >= 1) qb3::step_restore(vals, rung);  // rung 0 only on garbage input
    const uint64_t c2 = cf << 1;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const uint64_t v = vals[i], s = v & 1ull;
      vals[i] = static_cast<T>((((v >> 1) + s) * c2 - s) & mask);
    }
  } else if (kind == kCf0) {
    const T neg = static_cast<T>((((cf - 1) << 1) | 1ull) & mask);
#pragma unroll
    for (int i = 0; i < 16; ++i) vals[i] = vals[i] ? neg : static_cast<T>(0);
  }
}

// An IDX group's uniques: vals holds the 16 index codes, unique() decodes
// the next unique, read for u <= the largest index, into table (the
// thread's own 16 values of its warp's output staging, free until the
// values are staged), then each index takes its unique from the table (an
// index above 7 takes unique 7, as qb3_tpu's clip does; rung-2 codes stop
// at 7).  A table in registers, indexed by the codes, would sit in local
// memory, and one compared against every index holds twice the registers.
template <typename T, class Unique>
__device__ __forceinline__ void take_uniques(T (&vals)[16], T* table, Unique unique) {
  uint32_t maxidx = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const uint32_t v = vals[i] > 8 ? 8u : static_cast<uint32_t>(vals[i]);
    maxidx = v > maxidx ? v : maxidx;
  }
#pragma unroll
  for (uint32_t u = 0; u < 8; ++u)
    if (u <= maxidx) table[u] = unique();
#pragma unroll
  for (int i = 0; i < 16; ++i) vals[i] = table[vals[i] > 7 ? 7 : vals[i]];
}

// ---------------------------------------------------------------- K5a

// The u8 accumulator: 64 stream bits from the window bit of its low bit,
// navail of them counted valid, k the next row word to refill from.
struct Acc {
  uint64_t acc;
  int navail, k;
};

// Consume `shift` bits, then refill with `next` (row word k, read before
// the step's decodes) where fewer than 27 bits are left: a 3-value step
// uses <= 27 bits, less than the 32-bit refill.
__device__ __forceinline__ void consume(Acc& a, int shift, uint32_t next) {
  a.acc >>= shift;
  a.navail -= shift;
  if (a.navail < 27) {
    a.acc |= static_cast<uint64_t>(next) << a.navail;
    a.navail += 32;
    ++a.k;
  }
}

// The 16 codes of a u8 group: group-coded values at the rung (kinds 1 and
// 3), IDX's index codes (plain, at rung 2: the group code without its
// swap), literal bits (2 and 4), zeros (any other kind).  One loop for all
// kinds, so a warp that mixes IDX and other groups decodes its codes once.
__device__ __forceinline__ void codes8(const Row& row, int rung, int kind, Acc& a,
                                       uint32_t (&vals)[16]) {
  const bool idx = kind == kIdx, coded = kind == kGroup || kind == kCf || idx;
  const bool isb = kind == kBits || kind == kCf0;
  const int r = idx ? 2 : rung;
#pragma unroll
  for (int v0 = 0; v0 < 16; v0 += 3) {
    const uint32_t next = row[a.k];
    int shift = 0;
#pragma unroll
    for (int i = v0; i < (v0 + 3 < 16 ? v0 + 3 : 16); ++i) {
      const uint32_t ww = static_cast<uint32_t>(a.acc >> shift);
      int len;
      const uint32_t v = qb3::vlc_group32(ww, r, &len, !idx);
      vals[i] = coded ? v : (isb ? (ww & 1u) : 0u);
      shift += coded ? len : (isb ? 1 : 0);
    }
    consume(a, shift, next);
  }
}

__device__ __forceinline__ void walk8(const Row& row, int off, int rung, int kind, uint64_t cf,
                                      uint32_t (&vals)[16], uint32_t* table) {
  const int sh = off & 31;
  const int k = off >> 5;
  // 64-bit accumulator = (r0 | r1 << 32 | r2 << 64) >> sh
  Acc a{(static_cast<uint64_t>(row[k]) | static_cast<uint64_t>(row[k + 1]) << 32) >> sh,
        64 - sh, k + 2};
  if (sh) a.acc |= static_cast<uint64_t>(row[k + 2]) << (64 - sh);
  codes8(row, rung, kind, a, vals);
  if (kind == kCf || kind == kCf0) apply_cf(vals, kind, rung, cf, 0xFFull);
  if (kind != kIdx) return;
  take_uniques(vals, table, [&] {
    // a unique is <= 9 bits and at least 27 are held
    const uint32_t next = row[a.k];
    int ul;
    const uint32_t v =
        static_cast<uint32_t>(qb3::vlc_single64(static_cast<uint32_t>(a.acc), rung, &ul));
    consume(a, ul, next);
    return v;
  });
}

// ---------------------------------------------------------------- K5b

// The window of a wide walk: row words wi, wi + 1, wi + 2 in b0, b1, b2 and
// the bit sh in b0 where the window starts (window bit 32 * wi + sh).
struct Win {
  uint32_t b0, b1, b2;
  int wi, sh;
};

__device__ __forceinline__ Win win_at(const Row& row, int off) {
  const int wi = off >> 5;
  return Win{row[wi], row[wi + 1], row[wi + 2], wi, off & 31};
}

// The 64 window bits from the window's bit.
__device__ __forceinline__ uint64_t bits64(const Win& w) {
  return __funnelshift_r(w.b0, w.b1, w.sh) |
         static_cast<uint64_t>(__funnelshift_r(w.b1, w.b2, w.sh)) << 32;
}

// Advance the window by len bits.  ahead[] holds row words wi + 3 ..
// wi + 2 + P, read before the value's decode: an advance of up to P words is
// register moves; a longer one reads again.  A value's code takes up to 17
// bits at u16, 34 at u32 and 65 at u64, so from bit sh of a word it
// advances at most one word at u16 and two at u32; at u64 three only from
// bit 31 with a 65-bit code (and any width with a rung above its own).
template <int P>
__device__ __forceinline__ void advance(Win& w, int len, const uint32_t (&ahead)[P],
                                        const Row& row) {
  const int t = w.sh + len, d = t >> 5;
  w.sh = t & 31;
  if (d > P) {
    w = win_at(row, 32 * (w.wi + d) + w.sh);
    return;
  }
#pragma unroll
  for (int s = 0; s < P; ++s)
    if (d > s) {
      w.b0 = w.b1;
      w.b1 = w.b2;
      w.b2 = ahead[s];
    }
  w.wi += d;
}

// The 16 codes of a u16 / u32 / u64 group, kinds as codes8's.
template <int TBITS>
__device__ __forceinline__ void codes_wide(const Row& row, int rung, int kind, Win& w,
                                           uint64_t (&vals)[16]) {
  constexpr int P = TBITS == 16 ? 1 : 2;  // words read ahead (see advance)
  const bool idx = kind == kIdx, coded = kind == kGroup || kind == kCf || idx;
  const bool isb = kind == kBits || kind == kCf0;
  const int r = idx ? 2 : rung;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    uint32_t ahead[P];
#pragma unroll
    for (int s = 0; s < P; ++s) ahead[s] = row[w.wi + 3 + s];
    const uint64_t b = bits64(w);
    int len;
    uint64_t v;
    if (TBITS == 16) {
      v = qb3::vlc_group32(static_cast<uint32_t>(b), r, &len, !idx);
    } else {
      v = qb3::vlc64(b, r, &len, !idx);
      // rung-63 long form: the 65th stream bit is value bit 62
      if (TBITS == 64 && len == 65) v |= static_cast<uint64_t>((w.b2 >> w.sh) & 1u) << 62;
    }
    vals[i] = coded ? v : (isb ? (b & 1ull) : 0ull);
    advance(w, coded ? len : (isb ? 1 : 0), ahead, row);
  }
}

template <int TBITS>
__device__ __forceinline__ void walk_wide(const Row& row, int off, int rung, int kind,
                                          uint64_t cf, uint64_t (&vals)[16], uint64_t* table) {
  constexpr int P = TBITS == 16 ? 1 : 2;
  Win w = win_at(row, off);
  codes_wide<TBITS>(row, rung, kind, w, vals);
  if (kind == kCf || kind == kCf0) apply_cf(vals, kind, rung, cf, TBITS == 16 ? 0xFFFFull : ~0ull);
  if (kind != kIdx) return;
  take_uniques(vals, table, [&] {
    uint32_t ahead[P];
#pragma unroll
    for (int s = 0; s < P; ++s) ahead[s] = row[w.wi + 3 + s];
    const uint64_t b = bits64(w);
    int ul;
    // u16 reads its uniques from the window's low 32 bits, as
    // decode_groups_fused does; u32 / u64 from all 64
    const uint64_t v = qb3::vlc_single64(TBITS == 16 ? (b & 0xFFFFFFFFull) : b, rung, &ul);
    advance(w, ul, ahead, row);
    return v;
  });
}

// ---------------------------------------------------------------- kernel

// Piece q (16 bytes) of lane l's group in its warp's staging area: lanes
// of a quarter-warp (one shared-memory cycle of 16-byte accesses) land on
// eight different bank quads, writing a piece each and reading a group's
// pieces alike.
template <int PIECES>
__device__ __forceinline__ int slot(int l, int q) {
  return l * PIECES + (q ^ (PIECES == 8 ? (l & 7) : ((l >> 1) & 3)));
}

// One block's walk.  TBITS 8: K5a, u32 values (4 pieces a group); 16 /
// 32 / 64: K5b, u64 values (8 pieces).
template <int TBITS>
__device__ __forceinline__ void walk_block(const uint32_t* __restrict__ regs, int64_t ngroups,
                                           int nreg, const int32_t* __restrict__ off_in,
                                           const int32_t* __restrict__ rung_in,
                                           const int32_t* __restrict__ kind_in,
                                           const uint64_t* __restrict__ cf_in,
                                           uint4* __restrict__ out) {
  using T = typename std::conditional<TBITS == 8, uint32_t, uint64_t>::type;
  constexpr int kPieces = 16 * sizeof(T) / 16;
  extern __shared__ __align__(128) unsigned char smem[];  // output staging, then the rows
  __shared__ __align__(8) uint64_t bar;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t g0 = static_cast<int64_t>(blockIdx.x) * kThreads, g = g0 + tid;
  const int nlive = static_cast<int>(ngroups - g0 < kThreads ? ngroups - g0 : kThreads);
  QB3_PHASE_BEGIN
  const qb3::Span sp[1] = {{reinterpret_cast<const unsigned char*>(regs + g0 * nreg),
                            smem + kThreads * 16 * sizeof(T),
                            static_cast<uint32_t>(nlive) * nreg * 4u, 4u}};
  qb3::stage_issue(sp, qb3::smem_addr(&bar));
  const bool live = g < ngroups;
  int off = 0, rung = 0, kind = kZero;  // a group past the end walks as zeros, unstored
  uint64_t cf = 0;
  if (live) {
    off = off_in[g];
    rung = rung_in[g];
    kind = kind_in[g];
    if (cf_in && (kind == kCf || kind == kCf0)) cf = cf_in[g];
  }
  __syncthreads();  // the barrier's init and the threads' edges, before any thread waits
  qb3::mbar_wait(qb3::smem_addr(&bar), 0);
  QB3_PHASE_WAIT(off ^ rung ^ kind)
  QB3_PHASE(0)

  // the warp's 32 groups (contiguous in out) leave through its staging
  // area; until then the thread's own 16 values there hold IDX uniques
  uint4* st = reinterpret_cast<uint4*>(smem) + warp * 32 * kPieces;
  T vals[16];
  const Row row{reinterpret_cast<const uint32_t*>(sp[0].dst()) + tid * nreg, nreg};
  T* table = reinterpret_cast<T*>(st + lane * kPieces);
  if constexpr (TBITS == 8)
    walk8(row, off, rung, kind, cf, vals, table);
  else
    walk_wide<TBITS>(row, off, rung, kind, cf, vals, table);
  QB3_PHASE(1)

#pragma unroll
  for (int q = 0; q < kPieces; ++q) {
    uint4 v;
    if constexpr (TBITS == 8)
      v = make_uint4(vals[4 * q], vals[4 * q + 1], vals[4 * q + 2], vals[4 * q + 3]);
    else
      v = make_uint4(static_cast<uint32_t>(vals[2 * q]), static_cast<uint32_t>(vals[2 * q] >> 32),
                     static_cast<uint32_t>(vals[2 * q + 1]),
                     static_cast<uint32_t>(vals[2 * q + 1] >> 32));
    st[slot<kPieces>(lane, q)] = v;
  }
  __syncwarp();
  const int wlive = nlive - 32 * warp;  // groups of the warp that exist, if < 32
  uint4* dst = out + (g0 + 32 * warp) * kPieces;
#pragma unroll
  for (int r = 0; r < kPieces; ++r) {
    const int k = lane + 32 * r, gl = k / kPieces;
    if (gl < wlive) dst[k] = st[slot<kPieces>(gl, k % kPieces)];
  }
  QB3_PHASE(2)
  if (live) {
    QB3_PHASE_END(g)
  }
}

__global__ void __launch_bounds__(kThreads)
    wavefront8_kernel(const uint32_t* __restrict__ regs, int64_t ngroups, int nreg,
                      const int32_t* __restrict__ off, const int32_t* __restrict__ rung,
                      const int32_t* __restrict__ kind, const uint64_t* __restrict__ cf,
                      uint4* __restrict__ out) {
  walk_block<8>(regs, ngroups, nreg, off, rung, kind, cf, out);
}

template <int TBITS>
__global__ void __launch_bounds__(kThreads)
    wavefront_wide_kernel(const uint32_t* __restrict__ regs, int64_t ngroups, int nreg,
                          const int32_t* __restrict__ off, const int32_t* __restrict__ rung,
                          const int32_t* __restrict__ kind, const uint64_t* __restrict__ cf,
                          uint4* __restrict__ out) {
  walk_block<TBITS>(regs, ngroups, nreg, off, rung, kind, cf, out);
}

template <int TBITS>
int launch(const void* regs, int64_t ngroups, int nreg, const void* off, const void* rung,
           const void* kind, const void* cf, void* out, void* stream) {
  auto kern = TBITS == 8 ? wavefront8_kernel : wavefront_wide_kernel<TBITS == 8 ? 16 : TBITS>;
  const uint32_t smem = kThreads * 16 * (TBITS == 8 ? 4 : 8) +
                        qb3::region_bytes(static_cast<uint32_t>(kThreads) * nreg * 4);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kern<<<static_cast<unsigned>((ngroups + kThreads - 1) / kThreads), kThreads, smem,
         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(regs), ngroups, nreg, static_cast<const int32_t*>(off),
      static_cast<const int32_t*>(rung), static_cast<const int32_t*>(kind),
      static_cast<const uint64_t*>(cf), static_cast<uint4*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K5a.  regs (ngroups, nreg) u32, 4-byte aligned, nreg in [1, 384]; off /
// rung / kind (ngroups,) int32; cf (ngroups,) u64 or null (read for kinds 3
// and 4 only; null reads 0); out (ngroups, 16) u32, 16-byte aligned.
extern "C" int qb3_wavefront8(const void* regs, int64_t ngroups, int nreg, const void* off,
                              const void* rung, const void* kind, const void* cf, void* out,
                              void* stream) {
  if (nreg < 1 || nreg > kMaxNreg) return static_cast<int>(cudaErrorInvalidValue);
  if (ngroups <= 0) return static_cast<int>(cudaGetLastError());
  return launch<8>(regs, ngroups, nreg, off, rung, kind, cf, out, stream);
}

// K5b.  As K5a for tbits 16 / 32 / 64; out (ngroups, 16) u64.
extern "C" int qb3_wavefront_wide(const void* regs, int64_t ngroups, int nreg, int tbits,
                                  const void* off, const void* rung, const void* kind,
                                  const void* cf, void* out, void* stream) {
  if (nreg < 1 || nreg > kMaxNreg || (tbits != 16 && tbits != 32 && tbits != 64))
    return static_cast<int>(cudaErrorInvalidValue);
  if (ngroups <= 0) return static_cast<int>(cudaGetLastError());
  return tbits == 16 ? launch<16>(regs, ngroups, nreg, off, rung, kind, cf, out, stream)
       : tbits == 32 ? launch<32>(regs, ngroups, nreg, off, rung, kind, cf, out, stream)
                     : launch<64>(regs, ngroups, nreg, off, rung, kind, cf, out, stream);
}
