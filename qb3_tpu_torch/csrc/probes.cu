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
// arithmetic (P1: 2 * 64 * 128 * 256 = 4.2 MFLOP), so each is bound by its
// launch: a few microseconds.  The designs aim at right and simple:
//
//  P1  C = A^T B, A (K, M) and B (K, N) bf16, C (M, N) f32: the contraction
//      runs over A's rows, so a block stages column m of A (stride M in
//      memory) in shared memory, transposed into a contiguous row, and its
//      threads each take one output of row m, reading B's row k at
//      neighbouring addresses; f32 accumulation of the bf16 products, in
//      the body, with no library call.
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

__global__ void dim0_dot_kernel(const __nv_bfloat16* __restrict__ a,
                                const __nv_bfloat16* __restrict__ b, int K, int M, int N,
                                float* __restrict__ out) {
  extern __shared__ float acol[];  // column m of A, K values
  const int m = blockIdx.x;
  for (int k = threadIdx.x; k < K; k += blockDim.x) acol[k] = __bfloat162float(a[k * M + m]);
  __syncthreads();
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    float acc = 0.f;
    for (int k = 0; k < K; ++k) acc = fmaf(acol[k], __bfloat162float(b[k * N + n]), acc);
    out[m * N + n] = acc;
  }
}

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

// P1.  a (K, M) bf16, b (K, N) bf16 -> out (M, N) f32 = a^T b.
extern "C" int qb3_probe_dim0_dot(const void* a, const void* b, int K, int M, int N, void* out,
                                  void* stream) {
  if (K < 1 || M < 1 || N < 1 || K > 12 * 1024)  // column m in 48 KB of shared memory
    return static_cast<int>(cudaErrorInvalidValue);
  dim0_dot_kernel<<<M, 128, K * sizeof(float), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b), K, M, N,
      static_cast<float*>(out));
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
