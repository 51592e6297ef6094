// K6 (place_slabs) for qb3_tpu_torch, sm_90a.
//
// Replaces qb3_tpu/ops/pack_pallas.py: place_slabs (_placement_kernel).
//
// What it computes: out[base[g] + j] += slab[g, j] for every slab g and
// word j < W, dropping words at or past n_words; out starts at zero.  The
// slabs' contributions touch disjoint bits, so the sum is the bitwise OR
// and exact in any order.  On the strip encode it is the device stitch
// (stitch.stitch_words_device): each strip's words, shifted to the strip's
// bit phase, cut into W-word slabs at sorted word bases.
//
// Bound: memory.  It reads each slab word and each base once and writes
// each output word once (the wrapper's zero fill writes it once more); one
// add a word.
//
// Design: one thread per slab word, consecutive threads on consecutive
// slab words (coalesced reads, and within a slab consecutive output
// words), each a 32-bit atomicAdd into the output the wrapper zeroed.
// Only the words two slabs share (a strip's first and last, at the seam
// with its neighbour) see more than one add, so the atomics do not
// contend; the sum does not depend on their order.  The TPU kernel's
// sequential grid, 128-word aligned windows, SUB rows and lane masks are
// Mosaic rules and are not carried over.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

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

}  // namespace

// K6.  slab (ngroups, W) u32; base (ngroups,) int32 word offsets; out
// (n_words,) u32, zeroed by the caller.
extern "C" int qb3_place_slabs(const void* slab, const void* base, int64_t ngroups, int W,
                               void* out, int64_t n_words, void* stream) {
  if (W < 1 || ngroups < 0 || n_words < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total = ngroups * W;
  if (total > 0) {
    int64_t blocks = (total + kThreads - 1) / kThreads;
    if (blocks > 132 * 64) blocks = 132 * 64;  // grid-stride beyond 64 blocks an SM
    place_slabs_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(slab), static_cast<const int32_t*>(base), total, W,
        static_cast<uint32_t*>(out), n_words);
  }
  return static_cast<int>(cudaGetLastError());
}
