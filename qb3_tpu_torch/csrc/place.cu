// K6 (place_slabs) for qb3_tpu_torch, sm_90a.
//
// Replaces qb3_tpu/ops/pack_pallas.py: place_slabs (_placement_kernel).
//
// Two entries:
//   * the stitch entry (place_parts_kernel, stitch.stitch_words_device),
//     the device stitch of every strip and sharded encode: a stream of
//     n_out 32-bit words from runs of source words sorted by output
//     position, one run a part, its words read where they lie and placed
//     at the part's bit offset.  Word k of a run is
//     __funnelshift_l(src[k - 1], src[k], offset & 31) at output word
//     (offset >> 5) + k, source words past the part's last reading 0 and
//     the last masked to the part's bit total.  Output word i is the OR of
//     every run's contribution to it, and 0 where no run lands;
//   * the slab entry (place_slabs_kernel, place_slabs), the TPU kernel's
//     function: out[base[g] + j] += slab[g, j] for every slab g and word
//     j < W, bases in any order, dropping words at or past n_words, out
//     zeroed by the wrapper; one 32-bit atomicAdd a slab word.  No path of
//     the program calls it: the stitch entry took its place.
//
// Bound: memory.  The stitch entry reads each part's words once and writes
// each output word once; a few integer operations a word.
//
// Design of the stitch entry: output-major, so each word is written once,
// with no zero fill and no atomics.  Because both the starts and the ends
// of the runs are non-decreasing, the runs that touch a stretch of output
// words are one contiguous range of the table.  A warp owns kIter *
// kWarpRound consecutive words and places them in kIter rounds, lane l the
// kPer words at kPer * l of each round's stretch: neighbouring lanes read
// neighbouring source words (a lane's src[k - 1] is its neighbour's
// src[k], met again in L1) and write their words with 16-byte stores, 512
// contiguous bytes a warp.  The warp finds its first run with 32 probes a
// round (a ballot narrows the range 32-fold), and from there each lane
// walks its run range forward as its words advance, so a word costs no
// search.  No shared memory and no barrier: a block's warps are
// independent.  The TPU kernel's sequential grid, 128-word aligned
// windows, SUB rows and lane masks are Mosaic rules and are not carried
// over, and the stitch entry needs no slabs at all: they were W-word rows
// cut for Mosaic's VMEM tiles.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kPer = 4;                // consecutive output words a lane places at once
constexpr int kWarpRound = 32 * kPer;  // consecutive output words a warp places at once
constexpr int kIter = 4;               // rounds a warp, over consecutive stretches
constexpr int kWarpWords = kWarpRound * kIter;     // output words a warp
constexpr int kTile = kThreads / 32 * kWarpWords;  // output words a block

__device__ __forceinline__ int64_t ld64(const int64_t* p) {
  return static_cast<int64_t>(__ldg(reinterpret_cast<const long long*>(p)));
}

// The stitch entry's runs: table is (6, n) int64, one column a part: its
// words' address, output word base, end word (one past its last output
// word), source words, shift (bit offset & 31) and last-word mask.
struct PartRuns {
  const int64_t* table;
  int n;

  __device__ int64_t start(int r) const { return ld64(table + n + r); }
  __device__ int64_t end(int r) const { return ld64(table + 2 * n + r); }
  // ORs run r's words into w, the output words i0 .. i0 + kPer - 1
  __device__ void place(int r, int64_t i0, uint32_t (&w)[kPer]) const {
    const uint32_t* src = reinterpret_cast<const uint32_t*>(ld64(table + r));
    const int64_t s = start(r), e = end(r), nw = ld64(table + 3 * n + r);
    const int sh = static_cast<int>(ld64(table + 4 * n + r));
    const uint32_t mask = static_cast<uint32_t>(ld64(table + 5 * n + r));
    uint32_t v[kPer + 1];  // source words k0 - 1 .. k0 + kPer - 1, 0 outside the part
    const int64_t k0 = i0 - s;
#pragma unroll
    for (int j = 0; j <= kPer; ++j) {
      const int64_t k = k0 - 1 + j;
      const uint32_t x = (k >= 0 && k < nw) ? __ldg(src + k) : 0u;
      v[j] = k == nw - 1 ? x & mask : x;
    }
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      const int64_t i = i0 + c;
      if (i >= s && i < e) w[c] |= __funnelshift_l(v[c], v[c + 1], sh);
    }
  }
};

// The first r in [lo, hi) where pred(r) holds, or hi; pred is false, then
// true, over the range.  Called by a whole warp: each round probes 32
// evenly spaced runs and keeps the stretch between the last false and the
// first true probe.
template <class Pred>
__device__ int warp_search(Pred pred, int lo, int hi) {
  const int lane = threadIdx.x & 31;
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) / 32;
    const int p = lo + lane * step;
    const unsigned m = __ballot_sync(~0u, p >= hi || pred(p));
    if (m == 0) {  // every probe false, and all lie below hi
      lo += 31 * step + 1;
    } else {
      const int f = __ffs(m) - 1;
      const int pf = lo + f * step;
      if (f > 0) lo += (f - 1) * step + 1;
      if (pf < hi) hi = pf;
    }
  }
  const int p = lo + lane;
  const unsigned m = __ballot_sync(~0u, p >= hi || pred(p));
  return m == 0 ? hi : lo + (__ffs(m) - 1);
}

// The stitch entry, one output-major pass: warp v of the grid writes
// output words [v * kWarpWords, (v + 1) * kWarpWords) that lie below
// n_out, each once.
__global__ void __launch_bounds__(kThreads)
    place_parts_kernel(const int64_t* __restrict__ table, int nruns,
                       uint32_t* __restrict__ out, int64_t n_out) {
  const PartRuns runs{table, nruns};
  const int64_t wbase =
      (static_cast<int64_t>(blockIdx.x) * (kThreads / 32) + (threadIdx.x >> 5)) * kWarpWords;
  if (wbase >= n_out) return;  // the whole warp
  // [lo, hi): the runs that touch a lane's words i0 .. i0 + kPer - 1, those
  // ending past i0 and starting before i0 + kPer
  int lo = warp_search([&](int q) { return runs.end(q) > wbase; }, 0, runs.n), hi = lo;
  const int64_t first = wbase + (threadIdx.x & 31) * kPer;
  for (int j = 0; j < kIter; ++j) {
    const int64_t i0 = first + j * kWarpRound;
    if (i0 >= n_out) break;
    while (lo < runs.n && runs.end(lo) <= i0) ++lo;
    if (hi < lo) hi = lo;
    while (hi < runs.n && runs.start(hi) < i0 + kPer) ++hi;
    uint32_t w[kPer] = {};
    for (int r = lo; r < hi; ++r) runs.place(r, i0, w);
    if (i0 + kPer <= n_out) {
#pragma unroll
      for (int c = 0; c < kPer; c += 4) {
        *reinterpret_cast<uint4*>(out + i0 + c) = make_uint4(w[c], w[c + 1], w[c + 2], w[c + 3]);
      }
    } else {
#pragma unroll
      for (int c = 0; c < kPer; ++c) {
        if (i0 + c < n_out) out[i0 + c] = w[c];
      }
    }
  }
}

constexpr int kAtomicThreads = 256;

__global__ void place_slabs_kernel(const uint32_t* __restrict__ slab,
                                   const int32_t* __restrict__ base, int64_t nwords_in,
                                   int W, uint32_t* __restrict__ out, int64_t n_words) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < nwords_in; e += stride) {
    const int64_t g = e / W;
    const int64_t i = static_cast<int64_t>(base[g]) + (e - g * W);
    const uint32_t v = slab[e];
    if (v != 0u && i >= 0 && i < n_words) atomicAdd(out + i, v);
  }
}

unsigned pass_blocks(int64_t n_out) { return static_cast<unsigned>((n_out + kTile - 1) / kTile); }

constexpr int64_t kMaxRuns = (int64_t{1} << 31) - 33;  // run indices are 32-bit, with room

}  // namespace

// K6's slab entry, bases in any order.  slab (ngroups, W) u32; base
// (ngroups,) int32 word offsets; out (n_words,) u32, zeroed by the caller.
extern "C" int qb3_place_slabs(const void* slab, const void* base, int64_t ngroups, int W,
                               void* out, int64_t n_words, void* stream) {
  if (W < 1 || ngroups < 0 || n_words < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total = ngroups * W;
  if (total > 0) {
    int64_t blocks = (total + kAtomicThreads - 1) / kAtomicThreads;
    if (blocks > 132 * 64) blocks = 132 * 64;  // grid-stride beyond 64 blocks an SM
    place_slabs_kernel<<<static_cast<unsigned>(blocks), kAtomicThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(slab), static_cast<const int32_t*>(base), total, W,
        static_cast<uint32_t*>(out), n_words);
  }
  return static_cast<int>(cudaGetLastError());
}

// K6's stitch entry.  table (6, nruns) int64 on the device, one column a
// part, sorted by output position (stitch.stitch_runs, the first row the
// parts' addresses); out (n_out,) u32, every word written.
extern "C" int qb3_place_parts(const void* table, int64_t nruns, void* out, int64_t n_out,
                               void* stream) {
  if (nruns < 0 || nruns > kMaxRuns || n_out < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n_out > 0) {
    place_parts_kernel<<<pass_blocks(n_out), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int64_t*>(table), static_cast<int>(nruns),
        static_cast<uint32_t*>(out), n_out);
  }
  return static_cast<int>(cudaGetLastError());
}
