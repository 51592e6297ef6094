// The device-side group packer that K1 (pack.cu) and K8 (encode_image.cu)
// share, for sm_90.
//
// Both kernels write variable-length groups of bits one after another into
// a stream per tile: group g starts at the sum of the lengths of the
// tile's earlier groups.  The stream is little-endian at bit level: bit p
// lives in 32-bit word p >> 5 at weight 1 << (p & 31).  A block (CTA) takes
// consecutive groups of one tile and, in one launch:
//
//   1. takes its index from a ticket in start order and stages its inputs
//      in shared memory (stage: bulk asynchronous copies of each contiguous
//      span, the unaligned edges through the threads);
//   2. scans its groups' lengths across the block with warp shuffles
//      (block_scan) and publishes its sum at once;
//   3. ORs each group's codes into a shared-memory window of the block's
//      output words at the group's bit offset within the block, kParts
//      threads a group, each with its share of the codes at its offset in
//      the group (SmemWriter: the bits not yet written in a 64-bit
//      register, a word stored when it is full; a thread's first and last
//      word, which a neighbouring thread may share, with a shared-memory
//      atomicOr, the words between plainly);
//   4. then finds its start bit in the tile with a decoupled look-back over
//      the tile's earlier blocks (lookback, warp 0; a block only waits on
//      blocks that took their tickets before it, as K4 does in
//      fusedwin.cu) and publishes its inclusive prefix;
//   5. stores its words once (store_window): the window shifted to the
//      start bit's phase, interior words with plain coalesced stores,
//      16-byte where aligned, and only the first and last word, which a
//      neighbouring block may share, with a global atomicOr.
//
// Where a tile's blocks all run at once (one tile on the card) each phase is
// a latency the block waits out; ab_phases.py prints them per block.  Two
// threads a group, the 64-bit writer and the look-back after the placement
// were the fastest of the variants it timed on the H100 (PERF.md).
//
// The entry points zero the output words, the tiles' totals and the
// look-back's ticket and state with one cudaMemsetAsync before the launch,
// so the words a block shares and each tile's words past its total read
// zero.  Words at or past n_words are dropped, like the JAX package's
// scatter.  A window is sized from the hard maximum of a group's bits,
// which the kernels enforce on their inputs, so no input can overflow it.

#pragma once

#include <cstdint>

#include "bulk.cuh"

namespace qb3 {

// ---------------------------------------------------------------- staging

// One contiguous span of device memory (elements of 4 or 8 bytes) to stage
// in shared memory.  It lands at region + (src & 15), so its 16-byte-aligned
// interior keeps the alignment a bulk copy needs; region is 16-byte aligned
// and holds bytes + 16.
struct Span {
  const unsigned char* src;
  unsigned char* region;
  uint32_t bytes;
  uint32_t esize;

  __device__ unsigned char* dst() const {
    return region + (reinterpret_cast<uintptr_t>(src) & 15);
  }
  // the aligned interior [*lo, *hi) in bytes from src; empty: 0, 0
  __device__ void interior(uint32_t* lo, uint32_t* hi) const {
    const uintptr_t s = reinterpret_cast<uintptr_t>(src);
    const uintptr_t a = (s + 15) & ~static_cast<uintptr_t>(15);
    const uintptr_t b = (s + bytes) & ~static_cast<uintptr_t>(15);
    *lo = b > a ? static_cast<uint32_t>(a - s) : 0u;
    *hi = b > a ? static_cast<uint32_t>(b - s) : 0u;
  }
};

// Shared-memory bytes a span region takes, a multiple of 16.
__host__ __device__ constexpr uint32_t region_bytes(uint32_t bytes) {
  return (bytes + 16 + 15) & ~15u;
}

// Stage N spans: thread 0 issues one bulk copy for each aligned interior on
// the block's mbarrier at bar and the threads copy the edges (stage_issue;
// the caller waits on bar after a __syncthreads); stage also waits, and
// returns in every thread once all of it is in shared memory.
template <int N>
__device__ inline void stage_issue(const Span (&sp)[N], uint32_t bar) {
  if (threadIdx.x == 0) {
    uint32_t total = 0;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      uint32_t lo, hi;
      sp[i].interior(&lo, &hi);
      total += hi - lo;
    }
    mbar_init(bar);
    mbar_arrive_expect_tx(bar, total);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      uint32_t lo, hi;
      sp[i].interior(&lo, &hi);
      if (hi > lo) bulk_copy(smem_addr(sp[i].dst() + lo), sp[i].src + lo, hi - lo, bar);
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    uint32_t lo, hi;
    sp[i].interior(&lo, &hi);
    const uint32_t e = sp[i].esize, head = lo / e, tail = hi / e, n = sp[i].bytes / e;
    for (uint32_t k = threadIdx.x; k < head + n - tail; k += blockDim.x) {
      const uint32_t j = k < head ? k : tail + k - head;
      if (e == 8)
        reinterpret_cast<uint64_t*>(sp[i].dst())[j] = reinterpret_cast<const uint64_t*>(sp[i].src)[j];
      else
        reinterpret_cast<uint32_t*>(sp[i].dst())[j] = reinterpret_cast<const uint32_t*>(sp[i].src)[j];
    }
  }
}

template <int N>
__device__ inline void stage(const Span (&sp)[N], uint32_t bar) {
  stage_issue(sp, bar);
  __syncthreads();  // the barrier's init and the edges, before any thread waits
  mbar_wait(bar, 0);
}

// ---------------------------------------------------------------- scan

// Exclusive prefix sum of v across the block (blockDim.x a multiple of 32,
// at most 1024) in thread order; *total gets the block's sum.  Warp scans by shuffles, then
// one warp scans the warps' sums.
__device__ inline int block_scan(int v, int* total) {
  __shared__ int s_warp[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nwarps ? s_warp[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += y;
    }
    s_warp[lane] = w;
  }
  __syncthreads();
  *total = s_warp[nwarps - 1];
  return (warp ? s_warp[warp - 1] : 0) + x - v;
}

// ---------------------------------------------------------------- look-back

// A block's state word: 0 until it publishes, then a flag in the top two
// bits (its own sum, or its inclusive prefix in the tile) over the value.
constexpr uint64_t kAgg = 1ull << 62, kPrefix = 2ull << 62, kValue = kAgg - 1;

__device__ __forceinline__ uint64_t load_relaxed64(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_relaxed64(uint64_t* p, uint64_t v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// How look-back state values combine: K1 and K8 add bit counts.
struct Sum {
  __device__ static uint64_t combine(uint64_t a, uint64_t b) { return a + b; }
};

// One warp of block vb: the combination (Op, whose identity is 0) of the
// published values of blocks first .. vb - 1 (the earlier blocks of its
// tile), whose state words lie `stride` words apart, read 32 * U at a time
// (U loads a lane in flight) back to the nearest inclusive prefix: a ballot
// finds the prefix, a butterfly of shuffles combines the values up to it.
// Each lane waits on earlier blocks, which took their tickets before this
// one, so they run or have run and publish their values before they wait on
// anything.  K4 (fusedwin.cu) combines packed band sums with its own Op.
template <class Op = Sum, int U = 1>
__device__ inline uint64_t lookback(const uint64_t* state, int64_t vb, int64_t first,
                                    int64_t stride = 1) {
  const int lane = threadIdx.x & 31;
  uint64_t excl = 0;
  for (int64_t base = vb - 1; base >= first; base -= 32 * U) {
    uint64_t s[U];
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const int64_t j = base - lane - 32 * i;
      s[i] = j >= first ? load_relaxed64(state + j * stride) : kPrefix;  // before the tile: 0
    }
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const int64_t j = base - lane - 32 * i;
      while (!(s[i] & (kAgg | kPrefix))) s[i] = load_relaxed64(state + j * stride);
    }
    uint64_t v = 0;
    bool found = false;  // the same in every lane
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const unsigned pm = __ballot_sync(0xffffffffu, (s[i] & kPrefix) != 0);
      if (!found) {
        const int stop = pm ? __ffs(pm) - 1 : 31;  // the nearest prefix
        v = Op::combine(v, lane <= stop ? (s[i] & kValue) : 0);
        found = pm != 0;
      }
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) v = Op::combine(v, __shfl_xor_sync(0xffffffffu, v, o));
    excl = Op::combine(excl, v);
    if (found) break;
  }
  return excl;
}

// The kParts lanes kParts * k .. kParts * k + kParts - 1 of a warp share a
// group: the exclusive prefix sum of v over them, and their sum.
constexpr int kParts = 2;  // threads a group

__device__ __forceinline__ int part_offset(int v) {
  const int q = threadIdx.x % kParts;
  int x = v;
#pragma unroll
  for (int d = 1; d < kParts; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (q >= d) x += y;
  }
  return x - v;
}

__device__ __forceinline__ int part_sum(int v) {
#pragma unroll
  for (int d = 1; d < kParts; d <<= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
  return v;
}

// ---------------------------------------------------------------- placement

// One thread's run of codes into the block's shared-memory window, from
// window bit `start`: the bits not yet written sit in a 64-bit register
// (the word being filled and the next), and each word the run fills goes
// out when it is full.  The run's first word and its last may hold another
// run's bits too (neighbouring runs share words but never bits), so those
// two are ORed in with a shared-memory atomicOr; the words between belong
// to this run alone and are stored plainly.
struct SmemWriter {
  uint32_t* win;
  int cur;       // window word being filled
  int fill;      // bits of it already held in acc
  uint64_t acc;  // those bits, then the ones above them
  bool first;

  __device__ SmemWriter(uint32_t* win_, int start)
      : win(win_), cur(start >> 5), fill(start & 31), acc(0), first(true) {}

  // Append the low `len` bits of `code` (0 <= len <= 32, nothing above them).
  __device__ __forceinline__ void put32(uint32_t code, int len) {
    acc |= static_cast<uint64_t>(code) << fill;
    fill += len;
    if (fill >= 32) {
      const uint32_t w = static_cast<uint32_t>(acc);
      if (first) {
        if (w) atomicOr(win + cur, w);
        first = false;
      } else {
        win[cur] = w;
      }
      acc >>= 32;
      fill -= 32;
      ++cur;
    }
  }

  // Append the low `len` bits of `code` (0 <= len <= 64, nothing above them).
  __device__ __forceinline__ void put(uint64_t code, int len) {
    if (len > 32) {
      put32(static_cast<uint32_t>(code), 32);
      put32(static_cast<uint32_t>(code >> 32), len - 32);
    } else {
      put32(static_cast<uint32_t>(code), len);
    }
  }

  // Write out the last word; call once after the last put.
  __device__ __forceinline__ void flush() {
    const uint32_t w = static_cast<uint32_t>(acc);
    if (fill > 0 && w) atomicOr(win + cur, w);
  }
};

// The low `len` bits of code (0 <= len <= 64).
__device__ __forceinline__ uint64_t low_bits(uint64_t code, int len) {
  return len >= 64 ? code : code & ((1ull << len) - 1);
}

// Zero the window words a block of L bits uses (and the one past them that
// the phase shift reads); every thread, then a __syncthreads by the caller.
__device__ __forceinline__ void clear_window(uint32_t* win, int L) {
  for (int k = threadIdx.x; k < (L >> 5) + 2; k += blockDim.x) win[k] = 0;
}

// ---------------------------------------------------------------- store

// Store window bits [0, L) at stream bit `start` of out (n_words words,
// zeroed beforehand): every thread of the block, after a __syncthreads.
__device__ inline void store_window(const uint32_t* win, int L, int64_t start, uint32_t* out,
                             int64_t n_words) {
  if (L <= 0) return;
  const int ph = static_cast<int>(start & 31);
  const int64_t w0 = start >> 5;
  const int64_t nw = ((ph + L - 1) >> 5) + 1;  // stream words the block touches
  const int64_t lim = n_words - w0;            // k < lim lies inside the stream
  auto word = [&](int64_t k) -> uint32_t {     // stream word w0 + k
    return ph ? (win[k] << ph) | (k ? win[k - 1] >> (32 - ph) : 0u) : win[k];
  };
  uint32_t* o = out + w0;
  const int64_t kb = 1, ke = nw - 1 < lim ? nw - 1 : lim;  // interior words [kb, ke)
  if (ke > kb) {
    const int64_t mis = (reinterpret_cast<uintptr_t>(o + kb) >> 2) & 3;
    const int64_t to16 = (4 - mis) & 3;  // words up to a 16-byte boundary
    const int64_t head = to16 < ke - kb ? to16 : ke - kb;
    const int64_t k4 = kb + head, nvec = (ke - k4) >> 2;
    for (int64_t k = kb + threadIdx.x; k < k4; k += blockDim.x) o[k] = word(k);
    for (int64_t q = threadIdx.x; q < nvec; q += blockDim.x) {
      const int64_t k = k4 + 4 * q;
      *reinterpret_cast<uint4*>(o + k) = make_uint4(word(k), word(k + 1), word(k + 2), word(k + 3));
    }
    for (int64_t k = k4 + 4 * nvec + threadIdx.x; k < ke; k += blockDim.x) o[k] = word(k);
  }
  if (threadIdx.x == 0) {
    uint32_t v;
    if (lim > 0 && (v = word(0))) atomicOr(o, v);
    if (nw > 1 && nw - 1 < lim && (v = word(nw - 1))) atomicOr(o + nw - 1, v);
  }
}

}  // namespace qb3
