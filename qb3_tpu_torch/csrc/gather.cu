// K7 (gather_slabs) for qb3_tpu_torch, sm_90a.
//
// Replaces qb3_tpu/ops/pack_pallas.py: gather_slabs (_gather_kernel).
//
// What it computes: out[g, j] = words[base[g] + j] for j < W, and 0 where
// base[g] + j lies outside [0, n) (the stream's zero slack).  On the decode
// without a sidecar it gathers every group's register window for K5: base
// is the group's first value bit >> 5, W the window words K5 walks.
//
// Bound: memory.  It reads base (4 bytes a group) and the stretch of the
// stream the windows cover once, writes W words a group, and does a few
// integer operations a word.
//
// Design: one block per tile of kGroups consecutive groups.  On the decode
// path base is sorted, so a tile's windows cover a short stretch of the
// stream: the block copies R words, from its first group's base word
// rounded down to 4, into shared memory with 16-byte loads (neighbouring
// threads on neighbouring addresses), then writes the tile's kGroups * W
// output words in order, each from shared memory.  A word outside the
// staged span (an unsorted base, or a tile wider than R) is read from the
// stream itself, so R moves only speed, never values.  The TPU kernel's
// 128-word window alignment, SUB rows and lane-mask sums are Mosaic rules
// and are not carried over.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kGroups = 128;   // groups per block (ops/gather_cuda.GATHER_G)
constexpr int kThreads = 256;
constexpr int kMaxR = 8192;    // staged words, 32 KB (ops/gather_cuda.GATHER_MAX_R)

__device__ __forceinline__ uint32_t word_at(const uint32_t* __restrict__ words,
                                            int64_t n, int64_t i) {
  return (i >= 0 && i < n) ? words[i] : 0u;
}

__global__ void gather_slabs_kernel(const uint32_t* __restrict__ words, int64_t n,
                                    const int32_t* __restrict__ base, int64_t ngroups,
                                    int W, int R, uint32_t* __restrict__ out) {
  extern __shared__ uint4 staged4[];  // R words
  __shared__ int32_t tbase[kGroups];
  const uint32_t* staged = reinterpret_cast<const uint32_t*>(staged4);
  const int64_t g0 = static_cast<int64_t>(blockIdx.x) * kGroups;
  const int ng = static_cast<int>(ngroups - g0 < kGroups ? ngroups - g0 : kGroups);
  for (int i = threadIdx.x; i < ng; i += blockDim.x) tbase[i] = base[g0 + i];
  const int64_t lo = static_cast<int64_t>(base[g0]) & ~int64_t{3};
  for (int q = threadIdx.x; q < R / 4; q += blockDim.x) {
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
  __syncthreads();
  uint32_t* dst = out + g0 * W;
  for (int e = threadIdx.x; e < ng * W; e += blockDim.x) {
    const int g = e / W;
    const int64_t i = static_cast<int64_t>(tbase[g]) + (e - g * W);
    const int64_t rel = i - lo;
    dst[e] = (rel >= 0 && rel < R) ? staged[rel] : word_at(words, n, i);
  }
}

}  // namespace

// K7.  words (n,) u32, 16-byte aligned; base (ngroups,) int32; out
// (ngroups, W) u32; R staged words per block, a multiple of 4 in [4, kMaxR].
extern "C" int qb3_gather_slabs(const void* words, int64_t n, const void* base,
                                int64_t ngroups, int W, int R, void* out, void* stream) {
  if (W < 1 || R < 4 || R % 4 != 0 || R > kMaxR)
    return static_cast<int>(cudaErrorInvalidValue);
  if (ngroups > 0) {
    const int64_t blocks = (ngroups + kGroups - 1) / kGroups;
    gather_slabs_kernel<<<static_cast<unsigned>(blocks), kThreads,
                          R * sizeof(uint32_t), static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(words), n, static_cast<const int32_t*>(base), ngroups,
        W, R, static_cast<uint32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
