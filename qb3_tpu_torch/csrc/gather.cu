// K7 (gather_slabs) for qb3_tpu_torch, sm_90a.
//
// Replaces qb3_tpu/ops/pack_pallas.py: gather_slabs (_gather_kernel).
//
// What it computes: out[g, j] = words[base[g] + j] for j < W, and 0 where
// base[g] + j lies outside [0, n) (the stream's zero slack).  On the decode
// without a sidecar it gathers every group's register window for K5: base
// is the group's first value bit >> 5, W the window words K5 walks (8, 12,
// 20 or 36: ops/decode._NREG_IX).
//
// Bound: memory.  It reads base (4 bytes a group) and the stretch of the
// stream the windows cover once, writes W words a group, and does a few
// integer operations a word: 0.66 us for the 49152 windows of 8 words of a
// u8 512x512x3 tile at 3.35 TB/s, 4.17 us for the 65536 of 36 words of a u64
// 1024x1024 raster.  At these sizes the card's latency sets the time: the
// block's two dependent reads (its first base, then the span it locates)
// and the number of instructions a word costs.
//
// Design: one block per tile of kGroups consecutive groups.  On the decode
// path base is sorted, so a tile's windows cover a short stretch of the
// stream: R words from its first group's base word rounded down to 4 (16
// bytes).  Where that span lies inside the stream, one thread stages it into
// shared memory with one bulk asynchronous copy (TMA) on an mbarrier while
// the threads load the tile's bases; elsewhere the threads stage it with
// 16-byte loads, zeros outside the stream.  The output leaves in 16-byte
// stores, neighbouring threads on neighbouring addresses: W is a template
// parameter for 8, 12, 20 and 36, so a store's group comes from a division
// by a constant (a multiply), each assembled from four shared-memory words
// at the group's offset.  A word outside the staged span (an unsorted or
// negative base, or a tile wider than R) is read from the stream itself, so
// R moves only speed, never values.  Any other W takes the general body,
// one 4-byte store a word.  The TPU kernel's 128-word window alignment, SUB
// rows and lane-mask sums are Mosaic rules and are not carried over.
// Measured on an H100 80GB HBM3 at 700 W (ab_gather.py, device time from
// the profiler): 0.0018-0.0019 ms at the u8 walk and 0.0039-0.0041 ms at
// u64, against 0.0024 and 0.0070 for the design it replaces (4-byte stores,
// a runtime division a word) and 0.0031-0.0033 and 0.0088-0.0095 for
// torch.take.

#include <cuda_runtime.h>

#include <cstdint>

#include "bulk.cuh"

namespace {

constexpr int kGroups = 128;   // groups per block (ops/gather_cuda.GATHER_G)
constexpr int kThreads = 256;
constexpr int kMaxR = 8192;    // staged words, 32 KB (ops/gather_cuda.GATHER_MAX_R)

__device__ __forceinline__ uint32_t word_at(const uint32_t* __restrict__ words,
                                            int64_t n, int64_t i) {
  return (i >= 0 && i < n) ? words[i] : 0u;
}

// W > 0, a multiple of 4: 16-byte stores; W == 0: the general body for any
// width w, 4-byte stores.
template <int W>
__global__ void __launch_bounds__(kThreads)
    gather_slabs_kernel(const uint32_t* __restrict__ words, int64_t n,
                        const int32_t* __restrict__ base, int64_t ngroups, int w, int R,
                        uint32_t* __restrict__ out) {
  extern __shared__ __align__(128) uint4 staged4[];  // R words
  __shared__ int32_t tbase[kGroups];
  __shared__ __align__(8) uint64_t bar;
  const uint32_t* staged = reinterpret_cast<const uint32_t*>(staged4);
  const int64_t g0 = static_cast<int64_t>(blockIdx.x) * kGroups;
  const int ng = static_cast<int>(ngroups - g0 < kGroups ? ngroups - g0 : kGroups);
  const int64_t lo = static_cast<int64_t>(base[g0]) & ~int64_t{3};
  const bool bulk = lo >= 0 && lo + R <= n;
  const uint32_t b = qb3::smem_addr(&bar);
  if (bulk) {
    if (threadIdx.x == 0) {
      qb3::mbar_init(b);
      qb3::bulk_load(qb3::smem_addr(staged4), words + lo, R * 4, b);
    }
  } else {
    for (int q = threadIdx.x; q < R / 4; q += kThreads) {
      const int64_t i = lo + 4 * static_cast<int64_t>(q);
      uint4 v;
      if (i >= 0 && i + 4 <= n) {
        v = *reinterpret_cast<const uint4*>(words + i);
      } else {
        v = make_uint4(word_at(words, n, i), word_at(words, n, i + 1),
                       word_at(words, n, i + 2), word_at(words, n, i + 3));
      }
      staged4[q] = v;
    }
  }
  for (int i = threadIdx.x; i < ng; i += kThreads) tbase[i] = base[g0 + i];
  __syncthreads();  // tbase, the threads' staging and the mbarrier's init
  if (bulk) qb3::mbar_wait(b, 0);
  if constexpr (W > 0) {
    constexpr int V = W / 4;  // 16-byte vectors a group
    uint4* dst = reinterpret_cast<uint4*>(out + g0 * W);
    for (int e = threadIdx.x; e < ng * V; e += kThreads) {
      const int g = e / V;
      const int64_t i = static_cast<int64_t>(tbase[g]) + 4 * (e - g * V);
      const int64_t rel = i - lo;
      uint4 v;
      if (rel >= 0 && rel + 4 <= R) {
        v = make_uint4(staged[rel], staged[rel + 1], staged[rel + 2], staged[rel + 3]);
      } else {
        v = make_uint4(word_at(words, n, i), word_at(words, n, i + 1),
                       word_at(words, n, i + 2), word_at(words, n, i + 3));
      }
      dst[e] = v;
    }
  } else {
    uint32_t* dst = out + g0 * w;
    for (int e = threadIdx.x; e < ng * w; e += kThreads) {
      const int g = e / w;
      const int64_t i = static_cast<int64_t>(tbase[g]) + (e - g * w);
      const int64_t rel = i - lo;
      dst[e] = (rel >= 0 && rel < R) ? staged[rel] : word_at(words, n, i);
    }
  }
}

template <int W>
void launch(const void* words, int64_t n, const void* base, int64_t ngroups, int w, int R,
            void* out, cudaStream_t stream) {
  const int64_t blocks = (ngroups + kGroups - 1) / kGroups;
  gather_slabs_kernel<W><<<static_cast<unsigned>(blocks), kThreads, R * sizeof(uint32_t),
                           stream>>>(static_cast<const uint32_t*>(words), n,
                                     static_cast<const int32_t*>(base), ngroups, w, R,
                                     static_cast<uint32_t*>(out));
}

}  // namespace

// K7.  words (n,) u32, 16-byte aligned; base (ngroups,) int32; out
// (ngroups, W) u32, 16-byte aligned; R staged words per block, a multiple of
// 4 in [4, kMaxR].
extern "C" int qb3_gather_slabs(const void* words, int64_t n, const void* base,
                                int64_t ngroups, int W, int R, void* out, void* stream) {
  if (W < 1 || R < 4 || R % 4 != 0 || R > kMaxR)
    return static_cast<int>(cudaErrorInvalidValue);
  if (ngroups > 0) {
    const auto s = static_cast<cudaStream_t>(stream);
    switch (W) {
      case 8: launch<8>(words, n, base, ngroups, W, R, out, s); break;
      case 12: launch<12>(words, n, base, ngroups, W, R, out, s); break;
      case 20: launch<20>(words, n, base, ngroups, W, R, out, s); break;
      case 36: launch<36>(words, n, base, ngroups, W, R, out, s); break;
      default: launch<0>(words, n, base, ngroups, W, R, out, s); break;
    }
  }
  return static_cast<int>(cudaGetLastError());
}
