// K1 (group pack) and K3 (window copy) for qb3_tpu_torch, sm_90a.
//
// Plain C entry points, bound with ctypes (qb3_tpu_torch/_build.py).  Each
// launches on the given stream and returns cudaGetLastError(); the Python
// wrappers (qb3_tpu_torch/ops/pack_cuda.py) allocate every buffer.

#include <cuda_runtime.h>

#include <cstdint>

#include "bitwriter.cuh"
#include "bulk.cuh"

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
// Design: one thread per group walks its S symbols in order through the
// shared bit writer (bitwriter.cuh): a 32-bit accumulator for the current
// output word, flushed with atomicOr when the walk moves to the next word.
// Groups may be shorter than 32 bits, so neighbouring groups share words;
// their bits never overlap, so OR is exact (the property that makes the TPU
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
  qb3::BitWriter bw(out + (g / groups_per_tile) * n_words, n_words, goff[g]);
  for (int s = 0; s < S; ++s) bw.put(codes[g * S + s], lens[g * S + s]);
  bw.flush();
}

// ---------------------------------------------------------------- K3
//
// Replaces qb3_tpu/ops/pack_pallas.py: extract_windows (_extract_kernel).
//
// What it computes: out[t, j] = words[wrow[t] * 128 + j] for j < R, and 0
// outside the stream (the zero slack of the JAX function).  On the "ic"
// decode it stages the tile windows that K2 reads.
//
// Bound: memory, a pure copy of n_tiles * R words: 0.27 us for one u8
// 512x512x3 tile (16 windows of 7168 words) at 3.35 TB/s, 35 us for 128
// tiles.  At one tile the card's latency, not its bandwidth, sets the
// time, so what counts is how many bytes are in flight at once.
//
// Design: each window is cut into slices of kSlice words, one 32-thread
// block a slice: one u8 tile gives 224 blocks for the 132 SMs, a u16
// 1024x1024 raster 576, 128 tiles 28672 (up to 32 blocks, 64 KB, in flight
// on each SM).  For a slice inside the stream one thread copies it with two
// bulk asynchronous copies (TMA): device memory into shared memory, an
// mbarrier wait, and shared memory back out to the window; the copy costs
// the block no registers and no per-word instructions.  Window starts are
// multiples of 512 bytes and R of 128 words, so every copy is 16-byte
// aligned and a multiple of 16 bytes long.  A slice that crosses the
// stream's end, or lies outside it, goes through the block's threads:
// 16-byte loads where the vector lies inside the stream, else word by word,
// zeros outside, written straight to the window.  Measured on an H100 80GB
// HBM3 at 700 W (ab_gather.py, device time from the profiler): 0.0015-0.0016
// ms for one u8 tile and 0.0390-0.0412 ms for 128 tiles, against 0.0026-
// 0.0027 and 0.0418-0.0425 for the design it replaces (one 256-thread block a
// window, one 16-byte load in flight a thread: 16 blocks at one tile) and
// 0.0029-0.0030 and 0.0868-0.0899 for torch.take.  An unrolled copy with
// several 16-byte loads in flight a thread was not measured.
constexpr int kSlice = 512;  // words a K3 block copies (2 KB)
constexpr int kSliceThreads = 32;

__global__ void __launch_bounds__(kSliceThreads)
    extract_windows_kernel(const uint32_t* __restrict__ words, int64_t n,
                           const int32_t* __restrict__ wrow, int R, int slices,
                           uint32_t* __restrict__ out) {
  __shared__ __align__(128) uint4 buf[kSlice / 4];
  __shared__ __align__(8) uint64_t bar;
  const int t = blockIdx.x / slices;
  const int j0 = (blockIdx.x - t * slices) * kSlice;
  const int len = min(kSlice, R - j0);  // a multiple of 128 words
  const int64_t i0 = static_cast<int64_t>(wrow[t]) * 128 + j0;
  uint32_t* dst = out + static_cast<int64_t>(t) * R + j0;
  if (i0 >= 0 && i0 + len <= n) {
    if (threadIdx.x == 0) {
      const uint32_t b = qb3::smem_addr(&bar);
      qb3::mbar_init(b);
      qb3::bulk_load(qb3::smem_addr(buf), words + i0, len * 4, b);
      qb3::mbar_wait(b, 0);
      qb3::bulk_store(dst, qb3::smem_addr(buf), len * 4);
    }
    return;
  }
  uint4* dst4 = reinterpret_cast<uint4*>(dst);
  for (int q = threadIdx.x; q < len / 4; q += kSliceThreads) {
    const int64_t i = i0 + 4 * q;
    uint4 v;
    if (i >= 0 && i + 4 <= n) {
      v = *reinterpret_cast<const uint4*>(words + i);
    } else {
      v.x = (i >= 0 && i < n) ? words[i] : 0u;
      v.y = (i + 1 >= 0 && i + 1 < n) ? words[i + 1] : 0u;
      v.z = (i + 2 >= 0 && i + 2 < n) ? words[i + 2] : 0u;
      v.w = (i + 3 >= 0 && i + 3 < n) ? words[i + 3] : 0u;
    }
    dst4[q] = v;
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

// K3.  words (n,) u32, 16-byte aligned; wrow (n_tiles,) int32; out
// (n_tiles, R) u32, 16-byte aligned; R a multiple of 128.
extern "C" int qb3_extract_windows(const void* words, int64_t n,
                                   const void* wrow, int n_tiles, int R,
                                   void* out, void* stream) {
  if (R % 128 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int slices = (R + kSlice - 1) / kSlice;
  const int64_t blocks = static_cast<int64_t>(n_tiles) * slices;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks > 0) {
    extract_windows_kernel<<<static_cast<unsigned>(blocks), kSliceThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(words), n, static_cast<const int32_t*>(wrow),
        R, slices, static_cast<uint32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
