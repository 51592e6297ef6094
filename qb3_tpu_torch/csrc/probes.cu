// P1-P7, the Hopper counterparts of the Mosaic probes, sm_90a.
//
// Replaces tools/probe_mosaic.py: probe_dim0_dot (P1), probe_1d_dma (P2),
// probe_flatten (P3), probe_3d_dma (P4), probe_lane_write (P5),
// probe_lane_concat (P6) and probe_flatten_big (P7).  Each TPU probe is one
// pallas_call that checks whether Mosaic lowers a primitive the fused
// kernels wanted; here each is a small kernel that computes the same
// function, so the port holds one hand-written kernel per TPU kernel.
//
// Bound: every probe moves a few KB to 128 KB and does next to no
// arithmetic, so each is bound by its launch: a few microseconds.
// (qb3_empty, an empty kernel of one 32-thread block, measures that floor.)
//
//  P1  C = A^T B, A (K, M) and B (K, N) bf16, C (M, N) f32.  At the probe's
//      (256, 64) x (256, 128) it is a launch and ~128 KB of traffic (96 KB
//      in, 32 KB out, from L2); its 4.2 MFLOP is nothing at 989 TFLOP/s.
//      So the design keeps the copies off the serial path and out of the
//      threads: the tensor cores (wgmma m64n16k16, bf16 in, f32 sums in
//      registers) do the products, both operands from shared memory,
//      where A (K, M) row-major is A^T's M-major layout and B (K, N) is
//      N-major, so both transposes belong to the instruction (its
//      transpose flags) and nothing is copied transposed.  One warpgroup a
//      CTA covers 64 rows of M and kP1TileN columns of N, so the probe's N
//      spreads over 8 SMs pulling from L2 at once.  Each CTA walks K in
//      kP1TileK-row slices through a ring of kP1Stages: the threads copy
//      the first kP1Stages slices into the no-swizzle core-matrix layout
//      at once (16-byte cp.async a chunk, zero filled past K, M or N), so
//      the probe's K costs one memory round trip; each slice's products
//      are left in flight while the next lands, and a stage is refilled
//      with a later slice once the tensor cores are done with it.  A row
//      whose byte stride is not a multiple of 16 (M or N not a multiple of
//      8, or a base not 16-byte aligned) is read by the threads two bytes
//      at a time into the same layout.  The sums go straight from the
//      accumulator fragments to device memory, 8 bytes a store.  Tile,
//      ring depth and epilogue were chosen by measurement on the H100
//      against n32-n128 tiles, rings of 1-4 slices and a bulk store through
//      shared memory, each slower (PERF.md, Findings).
//  P2  out[t, i] = src[off[t] + i]: the offset is read from device memory
//      by the block (the TPU's scalar prefetch), never on the host.  A plain
//      load per thread: cp.async.bulk, the Hopper form of make_async_copy,
//      needs 16-byte-aligned global addresses, and 137 * 4 bytes is not.
//  P3/P7  (R, C) -> (1, R * C): each output index split into its row and
//      column in the kernel.
//  P4  out[i, j, k] = src[i, off + j, k], the offset read from device
//      memory; a plain load per thread, as P2.
//  P5  (R, W) written into columns c0 .. c0 + W of a (R, Cout) output that
//      the kernel zeroes itself, one thread per output word.
//  P6  out[r, c] = x[r, c % W] + c / W: the concatenation of x, x + 1, ...
//      along the columns, one thread per output word.
// Words outside the source read as zero (the TPU's DMA would fault).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

unsigned blocks_for(int64_t n) { return static_cast<unsigned>((n + kThreads - 1) / kThreads); }

// P1's tiles: one warpgroup a CTA computes a kP1TileM x kP1TileN tile of C
// and walks K in kP1TileK slices (kP1TileK / 16 wgmma k16 steps) through a
// ring of kP1Stages slices in shared memory.
constexpr int kP1Threads = 128;
constexpr int kP1TileM = 64;
constexpr int kP1TileN = 16;  // wgmma_m64n16k16's N
constexpr int kP1TileK = 128;
constexpr int kP1Stages = 2;
static_assert(kP1TileN == 16 && kP1TileM == 64, "one m64n16k16 tile a CTA");
static_assert(kP1Stages * kP1TileK * (kP1TileM + kP1TileN) * 2 <= 48 * 1024,
              "P1's ring fits in static shared memory");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The wgmma descriptor of an operand in the no-swizzle layout: core
// matrices of 8 rows of 16 bytes (8 bf16 along M or N, rows along K), 128
// contiguous bytes each; lbo is the byte stride between core matrices
// along K, sbo along M or N.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32);
}

// d (64 x 16, f32, the accumulator fragments) += A (64 x 16) B (16 x 16),
// both bf16 in shared memory, both MN-major (the transpose flags set).
__device__ __forceinline__ void wgmma_m64n16k16(float (&d)[8], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1));
}

// Keep the compiler from moving accumulator registers across the
// asynchronous wgmma (CUTLASS's warpgroup_fence_operand).
template <int R>
__device__ __forceinline__ void fence_operand(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Rows k0 .. k0 + kP1TileK of columns c0 .. c0 + W of x (K rows of ld bf16)
// into shared memory at dst, in the no-swizzle MN-major layout: the 16
// bytes of row k, columns c0 + 8 * mc .. + 8, sit in core matrix (mc, kc =
// (k - k0) / 8) at 128 * (kc * W / 8 + mc) + 16 * ((k - k0) % 8): 128 bytes
// between core matrices along M or N, 16 * W along K.  Chunk c is row
// k0 + c / (W / 8), columns c0 + 8 * (c % (W / 8)), so neighbouring
// threads read neighbouring bytes of a row.  Chunks past K or ld are zero.
// vec: ld is a multiple of 8 and x 16-byte aligned, so each chunk is one
// cp.async (a chunk lies wholly inside or outside ld); else the threads
// read it by 2-byte loads.
template <int W>
__device__ __forceinline__ void stage_slice(uint32_t dst, const __nv_bfloat16* __restrict__ x,
                                            int K, int ld, int k0, int c0, bool vec) {
  constexpr int kChunks = kP1TileK * W / 8;
  for (int c = threadIdx.x; c < kChunks; c += kP1Threads) {
    const int mc = c % (W / 8), kr = c / (W / 8);
    const int k = k0 + kr, col = c0 + mc * 8;
    const uint32_t s = dst + 128 * ((kr >> 3) * (W / 8) + mc) + 16 * (kr & 7);
    const __nv_bfloat16* row = x + static_cast<int64_t>(k) * ld;
    if (vec) {
      const bool live = k < K && col < ld;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                   "l"(live ? row + col : x), "r"(live ? 16 : 0)
                   : "memory");
    } else {
      uint32_t w[4] = {0, 0, 0, 0};
      if (k < K) {
        const unsigned short* r = reinterpret_cast<const unsigned short*>(row);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (col + j < ld) w[j >> 1] |= static_cast<uint32_t>(__ldg(r + col + j)) << (16 * (j & 1));
      }
      asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(s), "r"(w[0]), "r"(w[1]),
                   "r"(w[2]), "r"(w[3])
                   : "memory");
    }
  }
}

__global__ void __launch_bounds__(kP1Threads)
    dim0_dot_kernel(const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ b,
                    int K, int M, int N, int vec_a, int vec_b, float* __restrict__ out) {
  constexpr uint32_t kStageA = kP1TileK * kP1TileM * 2, kStageB = kP1TileK * kP1TileN * 2;
  constexpr uint32_t kLboA = 16 * kP1TileM, kLboB = 16 * kP1TileN, kSbo = 128;
  __shared__ __align__(128) unsigned char sa[kP1Stages * kStageA];
  __shared__ __align__(128) unsigned char sb[kP1Stages * kStageB];
  const int m0 = blockIdx.x * kP1TileM, n0 = blockIdx.y * kP1TileN;
  const int nk = (K + kP1TileK - 1) / kP1TileK;
  const uint32_t a0 = smem_addr(sa), b0 = smem_addr(sb);
  float d[kP1TileN / 2];
#pragma unroll
  for (int i = 0; i < kP1TileN / 2; ++i) d[i] = 0.f;

  // slice j goes into stage j % kP1Stages as cp.async group j: the first
  // kP1Stages now, so at the probe's K every slice is in flight at once
  for (int j = 0; j < kP1Stages; ++j) {
    if (j < nk) {
      stage_slice<kP1TileM>(a0 + j * kStageA, a, K, M, j * kP1TileK, m0, vec_a);
      stage_slice<kP1TileN>(b0 + j * kStageB, b, K, N, j * kP1TileK, n0, vec_b);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  fence_operand(d);
  for (int j = 0; j < nk; ++j) {
    const int st = j % kP1Stages;
    // group j (slice j) has landed for this thread: kP1Stages + j groups
    // are committed, at most kP1Stages - 1 later ones pending; then it is
    // made visible to the tensor cores' proxy, and the barrier waits for
    // every thread's chunks
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kP1Stages - 1) : "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    // slice j's k16 steps, left in flight
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int s = 0; s < kP1TileK / 16; ++s)
      wgmma_m64n16k16(d, gmma_desc(a0 + st * kStageA + 2 * s * kLboA, kLboA, kSbo),
                      gmma_desc(b0 + st * kStageB + 2 * s * kLboB, kLboB, kSbo));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // slice j + kP1Stages into this stage once every warp is past its
    // products; the group is committed even when empty, to keep group j
    // slice j
    if (j + kP1Stages < nk) {
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      __syncthreads();
      const int k1 = (j + kP1Stages) * kP1TileK;
      stage_slice<kP1TileM>(a0 + st * kStageA, a, K, M, k1, m0, vec_a);
      stage_slice<kP1TileN>(b0 + st * kStageB, b, K, N, k1, n0, vec_b);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_operand(d);

  // thread t holds, for each 8 columns i, rows 16 * warp + lane / 4 (+ 8)
  // at columns 8 * i + 2 * (lane % 4) (+ 1)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool pairs = (N & 1) == 0;  // then col + 1 < N wherever col < N
#pragma unroll
  for (int i = 0; i < kP1TileN / 8; ++i) {
    const int col = n0 + 8 * i + 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + 16 * warp + (lane >> 2) + 8 * h;
      if (row >= M || col >= N) continue;
      float* p = out + static_cast<int64_t>(row) * N + col;
      if (pairs) {
        *reinterpret_cast<float2*>(p) = make_float2(d[4 * i + 2 * h], d[4 * i + 2 * h + 1]);
      } else {
        p[0] = d[4 * i + 2 * h];
        if (col + 1 < N) p[1] = d[4 * i + 2 * h + 1];
      }
    }
  }
}

__global__ void empty_kernel() {}

__global__ void dma_1d_kernel(const int32_t* __restrict__ src, int64_t n,
                              const int32_t* __restrict__ off, int L, int32_t* __restrict__ out) {
  const int t = blockIdx.y;
  const int64_t base = off[t];
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < L; i += gridDim.x * blockDim.x) {
    const int64_t j = base + i;
    out[static_cast<int64_t>(t) * L + i] = (j >= 0 && j < n) ? src[j] : 0;
  }
}

__global__ void flatten_kernel(const int32_t* __restrict__ in, int R, int C,
                               int32_t* __restrict__ out) {
  const int64_t j = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (j >= static_cast<int64_t>(R) * C) return;
  const int64_t r = j / C, c = j - r * C;
  out[j] = in[r * C + c];
}

__global__ void dma_3d_kernel(const int32_t* __restrict__ src, int D0, int D1, int D2,
                              const int32_t* __restrict__ off, int L,
                              int32_t* __restrict__ out) {
  const int64_t e = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (e >= static_cast<int64_t>(D0) * L * D2) return;
  const int64_t k = e % D2, rest = e / D2;
  const int64_t j = rest % L, i = rest / L;
  const int64_t row = static_cast<int64_t>(off[0]) + j;
  out[e] = (row >= 0 && row < D1) ? src[(i * D1 + row) * D2 + k] : 0;
}

__global__ void lane_write_kernel(const int32_t* __restrict__ x, int R, int W, int Cout,
                                  int c0, int32_t* __restrict__ out) {
  const int64_t e = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (e >= static_cast<int64_t>(R) * Cout) return;
  const int64_t r = e / Cout, c = e - r * Cout;
  out[e] = (c >= c0 && c < c0 + W) ? x[r * W + (c - c0)] : 0;
}

__global__ void lane_concat_kernel(const int32_t* __restrict__ x, int R, int W, int copies,
                                   int32_t* __restrict__ out) {
  const int64_t Cout = static_cast<int64_t>(W) * copies;
  const int64_t e = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (e >= R * Cout) return;
  const int64_t r = e / Cout, c = e - r * Cout;
  out[e] = x[r * W + c % W] + static_cast<int32_t>(c / W);
}

}  // namespace

// The launch floor: one block of 32 threads that does nothing.
extern "C" int qb3_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

// P1.  a (K, M) bf16, b (K, N) bf16 -> out (M, N) f32 = a^T b.
extern "C" int qb3_probe_dim0_dot(const void* a, const void* b, int K, int M, int N, void* out,
                                  void* stream) {
  const int tiles_n = N / kP1TileN + (N % kP1TileN != 0);
  if (K < 1 || M < 1 || N < 1 || tiles_n > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int vec_a = M % 8 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
  const int vec_b = N % 8 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0;
  const dim3 grid(M / kP1TileM + (M % kP1TileM != 0), tiles_n);
  dim0_dot_kernel<<<grid, kP1Threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b), K, M, N, vec_a,
      vec_b, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// P2.  src (n,) int32, off (T,) int32 on the device -> out (T, L) int32.
extern "C" int qb3_probe_dma_1d(const void* src, int64_t n, const void* off, int T, int L,
                                void* out, void* stream) {
  if (T < 1 || L < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(blocks_for(L), T);
  dma_1d_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(src), n, static_cast<const int32_t*>(off), L,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// P3 and P7.  in (R, C) int32 -> out (1, R * C) int32.
extern "C" int qb3_probe_flatten(const void* in, int R, int C, void* out, void* stream) {
  if (R < 1 || C < 1) return static_cast<int>(cudaErrorInvalidValue);
  flatten_kernel<<<blocks_for(static_cast<int64_t>(R) * C), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(static_cast<const int32_t*>(in), R, C,
                                                        static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// P4.  src (D0, D1, D2) int32, off (1,) int32 on the device -> out (D0, L, D2).
extern "C" int qb3_probe_dma_3d(const void* src, int D0, int D1, int D2, const void* off, int L,
                                void* out, void* stream) {
  if (D0 < 1 || D1 < 1 || D2 < 1 || L < 1) return static_cast<int>(cudaErrorInvalidValue);
  dma_3d_kernel<<<blocks_for(static_cast<int64_t>(D0) * L * D2), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(src), D0, D1, D2, static_cast<const int32_t*>(off), L,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// P5.  x (R, W) int32 -> out (R, Cout) int32, zero but columns c0 .. c0 + W.
extern "C" int qb3_probe_lane_write(const void* x, int R, int W, int Cout, int c0, void* out,
                                    void* stream) {
  if (R < 1 || W < 1 || c0 < 0 || c0 + W > Cout) return static_cast<int>(cudaErrorInvalidValue);
  lane_write_kernel<<<blocks_for(static_cast<int64_t>(R) * Cout), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), R, W, Cout, c0, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// P6.  x (R, W) int32 -> out (R, W * copies) int32, [x, x + 1, ...].
extern "C" int qb3_probe_lane_concat(const void* x, int R, int W, int copies, void* out,
                                     void* stream) {
  if (R < 1 || W < 1 || copies < 1) return static_cast<int>(cudaErrorInvalidValue);
  lane_concat_kernel<<<blocks_for(static_cast<int64_t>(R) * W * copies), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), R, W, copies, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
