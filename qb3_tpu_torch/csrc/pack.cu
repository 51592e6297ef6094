// K1 (group pack) and K3 (window copy) for qb3_tpu_torch, sm_90a.
//
// Plain C entry points, bound with ctypes (qb3_tpu_torch/_build.py).  Each
// launches on the given stream and returns cudaGetLastError(); the Python
// wrappers (qb3_tpu_torch/ops/pack_cuda.py) allocate every buffer.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// ---------------------------------------------------------------- K1
//
// Replaces qb3_tpu/ops/pack_pallas.py: pack_groups_chunked
// (_pack_chunks_kernel), encode phase B.
//
// What it computes: every symbol s of group g has a code (up to 64 bits)
// and a length; its bits land at stream bit goff[g] + (lengths of the
// earlier symbols of g).  The wrapper computes goff, the per-tile exclusive
// prefix sum of the group lengths, with torch.cumsum outside the kernel (as
// the JAX package does outside its kernel) and zero-fills the output.
//
// Bound: memory.  A group reads S codes (8 bytes) and S lengths (4 bytes)
// and writes about a tenth of that, so the kernel moves ~12 bytes per
// symbol and does a handful of integer operations on each.
//
// Design: one thread per group walks its S symbols in order, ORing the
// code's bits into a 32-bit accumulator for the current output word and
// flushing it with atomicOr when the walk moves to the next word.  Groups
// may be shorter than 32 bits, so neighbouring groups share words; their
// bits never overlap, so OR is exact (the property that makes the TPU
// kernel's byte sums exact).  The TPU kernel's slab tiling, bf16 one-hot
// MXU placement and diagonal combine exist for the MXU and are not carried
// over.  Words at or past n_words are dropped, like the JAX scatter.
__global__ void pack_groups_kernel(const uint64_t* __restrict__ codes,
                                   const int32_t* __restrict__ lens,
                                   const int64_t* __restrict__ goff,
                                   int64_t ngroups, int S,
                                   int64_t groups_per_tile, int64_t n_words,
                                   uint32_t* __restrict__ out) {
  const int64_t g = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (g >= ngroups) return;
  uint32_t* tile_out = out + (g / groups_per_tile) * n_words;
  int64_t p = goff[g];
  int64_t cur = p >> 5;
  uint32_t acc = 0;
  for (int s = 0; s < S; ++s) {
    uint64_t code = codes[g * S + s];
    int len = lens[g * S + s];
    while (len > 0) {
      const int64_t wi = p >> 5;
      const int sh = static_cast<int>(p & 31);
      const int take = len < 32 - sh ? len : 32 - sh;
      if (wi != cur) {
        if (acc && cur < n_words) atomicOr(tile_out + cur, acc);
        cur = wi;
        acc = 0;
      }
      acc |= static_cast<uint32_t>(code & ((1ull << take) - 1)) << sh;
      code >>= take;
      len -= take;
      p += take;
    }
  }
  if (acc && cur < n_words) atomicOr(tile_out + cur, acc);
}

// ---------------------------------------------------------------- K3
//
// Replaces qb3_tpu/ops/pack_pallas.py: extract_windows (_extract_kernel).
//
// What it computes: out[t, j] = words[wrow[t] * 128 + j] for j < R, and 0
// past the end of the stream (the zero slack of the JAX function).
//
// Bound: memory, a pure copy of n_tiles * R words.
//
// Design: one block per tile; its threads copy the window in 16-byte
// vectors, neighbouring threads on neighbouring addresses.  Window starts
// are multiples of 128 words and R is a multiple of 128, so every vector is
// aligned; only vectors that straddle the end of the stream go word by
// word.  On the decode path it stages the tile windows that K2 reads.
__global__ void extract_windows_kernel(const uint32_t* __restrict__ words,
                                       int64_t n, const int32_t* __restrict__ wrow,
                                       int R, uint32_t* __restrict__ out) {
  const int64_t t = blockIdx.x;
  const int64_t start = static_cast<int64_t>(wrow[t]) * 128;
  uint4* dst = reinterpret_cast<uint4*>(out + t * R);
  for (int j = threadIdx.x; j < R / 4; j += blockDim.x) {
    const int64_t i = start + 4 * static_cast<int64_t>(j);
    uint4 v;
    if (i >= 0 && i + 4 <= n) {
      v = *reinterpret_cast<const uint4*>(words + i);
    } else {
      v.x = (i >= 0 && i < n) ? words[i] : 0u;
      v.y = (i + 1 >= 0 && i + 1 < n) ? words[i + 1] : 0u;
      v.z = (i + 2 >= 0 && i + 2 < n) ? words[i + 2] : 0u;
      v.w = (i + 3 >= 0 && i + 3 < n) ? words[i + 3] : 0u;
    }
    dst[j] = v;
  }
}

}  // namespace

extern "C" int qb3_pack_groups(const void* codes, const void* lens,
                               const void* goff, int64_t ngroups, int S,
                               int64_t groups_per_tile, int64_t n_words,
                               void* out, void* stream) {
  if (ngroups > 0) {
    const int threads = 256;
    const int64_t blocks = (ngroups + threads - 1) / threads;
    pack_groups_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint64_t*>(codes), static_cast<const int32_t*>(lens),
        static_cast<const int64_t*>(goff), ngroups, S, groups_per_tile, n_words,
        static_cast<uint32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int qb3_extract_windows(const void* words, int64_t n,
                                   const void* wrow, int n_tiles, int R,
                                   void* out, void* stream) {
  if (R % 128 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n_tiles > 0) {
    extract_windows_kernel<<<n_tiles, 256, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(words), n, static_cast<const int32_t*>(wrow),
        R, static_cast<uint32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
