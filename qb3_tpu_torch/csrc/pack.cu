// K1 (group pack) and K3 (window copy) for qb3_tpu_torch, sm_90a.
//
// Plain C entry points, bound with ctypes (qb3_tpu_torch/_build.py).  Each
// launches on the given stream (K1 after one memset) and returns
// cudaGetLastError(); the Python wrappers (qb3_tpu_torch/ops/pack_cuda.py)
// allocate every buffer.

#include <cuda_runtime.h>

#include <cstdint>

#include "blockpack.cuh"
#include "bulk.cuh"

namespace {

// ---------------------------------------------------------------- K1
//
// Replaces qb3_tpu/ops/pack_pallas.py: pack_groups_chunked
// (_pack_chunks_kernel), encode phase B.
//
// What it computes: every symbol s of group g has a code (up to 64 bits)
// and a length; its bits land at stream bit goff[g] + (lengths of the
// earlier symbols of g), where goff is the per-tile exclusive prefix sum of
// the group lengths.  It also returns each group's length and each tile's
// total.  The JAX package takes goff with a cumsum outside its kernel; here
// the kernel scans the lengths itself (blockpack.cuh), so a call is one
// memset and one launch.
//
// Bound: memory.  A group reads S codes (8 bytes) and S lengths (4 bytes)
// and writes about a tenth of that: at 128 u8 512x512x3 tiles the inputs
// weigh 1.28 GB, 0.38 ms at 3.35 TB/s.
//
// Design: kGroups groups per block, kParts threads a group (blockpack.cuh);
// the grid runs over tiles x blocks per tile, so no block spans two tiles.
// A block's kGroups x S codes and lengths are contiguous: two bulk copies
// stage them, and the threads then read their symbols from shared memory
// (the design it replaces read them at a 136-byte stride from device
// memory, 32 cache lines a warp load).  The lengths are clamped to [0, 64],
// a code's width, so a group holds at most S * 64 bits and the window
// cannot overflow.  The TPU kernel's slab tiling, bf16 one-hot MXU
// placement and diagonal combine exist for the MXU and are not carried
// over.  Measured on an H100 80GB HBM3 at 700 W (ab_pack.py, device time
// from the profiler): a call (the memset and the kernel) takes 0.0092-
// 0.0093 ms at one u8 512x512x3 tile and 0.6608-0.6626 ms at 128 (the
// kernel alone 0.628 ms: 2.0 TB/s of int64 codes and int32 lengths),
// against 0.0305-0.0310 and 5.80-6.06 ms for the design it replaces (one
// thread a group, a global atomicOr a word) with its wrapper's scan, zero
// fill and narrowing.
constexpr int kGroups = 128;      // groups a block packs (ops/pack_cuda.PACK_G)
constexpr int kMaxSymbols = 64;   // S at most (ops/pack_cuda.PACK_MAX_S)
constexpr int kThreads = kGroups * qb3::kParts;

__host__ __device__ constexpr uint32_t k1_smem(int S) {
  return qb3::region_bytes(kGroups * S * 8) + qb3::region_bytes(kGroups * S * 4)
         + (kGroups * S * 2 + 2) * 4;
}

__device__ __forceinline__ int clamp_len(int32_t len) { return len < 0 ? 0 : (len > 64 ? 64 : len); }

__global__ void __launch_bounds__(kThreads, 4)
    pack_groups_kernel(const uint64_t* __restrict__ codes, const int32_t* __restrict__ lens,
                       int64_t ngroups, int S, int64_t bpt /* blocks a tile */, int64_t n_words,
                       uint32_t* __restrict__ out, int64_t* __restrict__ total,
                       int32_t* __restrict__ glen, int* ticket, uint64_t* state) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int64_t s_vb, s_start;
  __shared__ __align__(8) uint64_t bar;
  const int tid = threadIdx.x;
  if (tid == 0) s_vb = atomicAdd(ticket, 1);  // block index in start order
  __syncthreads();
  const int64_t vb = s_vb, tile = vb / bpt, c = vb - tile * bpt, first = vb - c;
  const int64_t g0 = c * kGroups;
  const int ng = static_cast<int>(ngroups - g0 < kGroups ? ngroups - g0 : kGroups);
  const int64_t e0 = (tile * ngroups + g0) * S;
  const uint32_t nsym = static_cast<uint32_t>(ng * S);
  unsigned char* rlens = smem + qb3::region_bytes(kGroups * S * 8);
  uint32_t* win = reinterpret_cast<uint32_t*>(rlens + qb3::region_bytes(kGroups * S * 4));
  const qb3::Span sp[2] = {
      {reinterpret_cast<const unsigned char*>(codes + e0), smem, nsym * 8, 8},
      {reinterpret_cast<const unsigned char*>(lens + e0), rlens, nsym * 4, 4}};
  qb3::stage(sp, qb3::smem_addr(&bar));

  // thread tid = kParts * group + part walks symbols [s0, s1) of its group:
  // thread order is symbol order, so one block scan places every part
  const int g = tid / qb3::kParts, q = tid % qb3::kParts;
  const int per = (S + qb3::kParts - 1) / qb3::kParts;
  const int s0 = g < ng ? min(S, q * per) : 0, s1 = g < ng ? min(S, s0 + per) : 0;
  const uint64_t* cs = reinterpret_cast<const uint64_t*>(sp[0].dst()) + g * S;
  const int32_t* ls = reinterpret_cast<const int32_t*>(sp[1].dst()) + g * S;
  int len = 0;
  for (int s = s0; s < s1; ++s) len += clamp_len(ls[s]);
  int L;
  const int lo = qb3::block_scan(len, &L);
  const int gl = qb3::part_sum(len);
  if (tid == 0) qb3::store_relaxed64(state + vb, (vb == first ? qb3::kPrefix : qb3::kAgg) | L);
  if (g < ng && q == 0) glen[tile * ngroups + g0 + g] = gl;
  qb3::clear_window(win, L);
  __syncthreads();

  if (s1 > s0) {
    qb3::SmemWriter w(win, lo);
    for (int s = s0; s < s1; ++s) {
      const int n = clamp_len(ls[s]);
      w.put(qb3::low_bits(cs[s], n), n);
    }
    w.flush();
  }
  if (tid < 32) {  // after the placement, so the earlier blocks had time to publish
    const int64_t excl = qb3::lookback(state, vb, first);
    if (tid == 0) {
      if (vb != first) qb3::store_relaxed64(state + vb, qb3::kPrefix | (excl + L));
      if (c == bpt - 1) total[tile] = excl + L;
      s_start = excl;
    }
  }
  __syncthreads();
  qb3::store_window(win, L, s_start, out + tile * n_words, n_words);
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

// K1.  codes (ntiles, ngroups, S) u64, lens the same shape int32, out
// (ntiles, n_words) u32, total (ntiles,) int64, glen (ntiles, ngroups)
// int32; scratch: the ticket (8 bytes) and nblocks state words (8 bytes
// each).  out, total and scratch lie in one span of zero_bytes from out,
// which the memset zeroes.  nblocks = ntiles * ceil(ngroups / kGroups).
extern "C" int qb3_pack_groups(const void* codes, const void* lens, int64_t ntiles,
                               int64_t ngroups, int S, int64_t n_words, void* out, void* total,
                               void* glen, void* scratch, int64_t zero_bytes, int64_t nblocks,
                               void* stream) {
  const int64_t bpt = (ngroups + kGroups - 1) / kGroups;
  if (S < 1 || S > kMaxSymbols || ntiles < 0 || ngroups < 0 || n_words < 0 ||
      nblocks != ntiles * bpt || nblocks > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto cs = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, static_cast<size_t>(zero_bytes), cs);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nblocks > 0) {
    const uint32_t smem = k1_smem(S);
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(pack_groups_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    auto* tk = static_cast<int*>(scratch);
    pack_groups_kernel<<<static_cast<unsigned>(nblocks), kThreads, smem, cs>>>(
        static_cast<const uint64_t*>(codes), static_cast<const int32_t*>(lens), ngroups, S,
        bpt, n_words, static_cast<uint32_t*>(out), static_cast<int64_t*>(total),
        static_cast<int32_t*>(glen), tk, reinterpret_cast<uint64_t*>(tk + 2));
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
