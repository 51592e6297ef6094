// K11 (the step of a quantized encode, with the widening to the carrier)
// for qb3_tpu_torch, sm_90a.
//
// Plain C entry point, bound with ctypes (qb3_tpu_torch/_build.py).  It
// launches one kernel on the given stream and returns cudaGetLastError();
// the Python wrapper (qb3_tpu_torch/ops/quantize_cuda.py) allocates the
// output.
//
// Replaces no TPU kernel: qb3_tpu quantizes on the host with NumPy
// (qb3_tpu/api.py quantize, about eight passes over the raster), and so did
// the port before K11, at ~49-53 ms a 512x6000 int16 strip of the strip
// encoder, while the same bytes went to the card anyway to be widened to
// the int64 carrier there by two PyTorch elementwise ops (api.widen).
//
// What it computes: for n values of one integer type, 8, 16, 32 or 64 bits,
// signed or unsigned as the encoder's type says (an unsigned raster is
// uploaded through its signed view, so the type is an argument and never
// read from the tensor), api.quantize's value at the step q
// (QB3encode.cpp:137-186), then the int64 carrier of its unsigned twin, as
// api.widen makes it.  In the type's own arithmetic: the quotient truncated
// toward zero, plus one where the remainder reaches lim, minus one where it
// reaches -lim; lim = q / 2 + 1 rounds ties toward zero, q - q / 2 away from
// zero.  That is api.quantize's special cases for q = 2, 3 and 4 and its
// general formula alike (its compares of a remainder and half the step
// never overflow where they count), and the result always fits the type.
// u64 divides unsigned: values above 2^63 quantize as NumPy's uint64 do.
//
// Bound: memory.  A value is read once at its width and written once as 8
// bytes, against a division and a few integer operations: at the strip
// encoder's 512x6000 int16 strip, 6.1 MB in and 24.6 MB out, 0.0092 ms at
// 3.35 TB/s.
//
// Design: an elementwise grid-stride loop on the current stream, a warp at
// a time over 32 consecutive 16-byte vectors of values (16 u8 ... 2 u64
// each).  Each thread loads one vector and stages its values' carriers in
// the warp's slice of shared memory; the warp then writes the slice out as
// 16-byte stores, neighbouring lanes on neighbouring addresses, so that
// each store instruction writes 512 whole bytes where a thread's own
// carriers would leave it at a stride of 8 values.  A scalar loop takes
// the tail past the last whole vector (all of it where a pointer is not
// 16-byte aligned).  Values up to 32 bits compute in 32-bit registers;
// q = 2, 3 and 4 are template constants, so that their division is a
// multiply and shift, and any other step takes a run-time division.
// Measured on an H100 80GB HBM3 at 700 W (device time from the profiler):
// 0.0102 ms at the 512x6000 int16 strip, 90% of the bound (0.0103 ms,
// 89%, with the L2 flushed before each call), against 0.0204-0.0212 ms for
// a design whose threads stored their own carriers, and 0.0270 ms for the
// two PyTorch ops of api.widen it replaces there.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 32;  // four waves of resident blocks on 132 SMs

// The arithmetic type of native type N: 32 bits up to 32-bit values, N's
// own at 64 bits; signed where N is.
template <typename N>
using Arith = std::conditional_t<sizeof(N) == 8, N,
                                 std::conditional_t<std::is_signed_v<N>, int32_t, uint32_t>>;

// One value's carrier: api.quantize's value at the step (Q, or q where Q is
// 0), its unsigned twin widened to int64.
template <typename N, int Q>
__device__ __forceinline__ int64_t carrier(N x, Arith<N> q, Arith<N> lim) {
  using T = Arith<N>;
  const T d = Q ? T(Q) : q;
  const T v = T(x);
  const T quo = v / d, rem = v % d;  // truncating, as C divides
  T r = quo + T(rem >= lim);
  if constexpr (std::is_signed_v<T>) r -= T(rem <= -lim);
  return static_cast<int64_t>(static_cast<uint64_t>(static_cast<std::make_unsigned_t<N>>(r)));
}

template <typename N, int Q>
__global__ void __launch_bounds__(kThreads)
    quantize_kernel(const N* __restrict__ in, int64_t n, int64_t nvec, Arith<N> q,
                    Arith<N> lim, int64_t* __restrict__ out) {
  constexpr int V = 16 / sizeof(N);  // values a 16-byte vector
  constexpr int S = 16 * V;          // 16-byte stores a warp's 32 vectors
  __shared__ longlong2 stage[kThreads / 32 * S];
  const int lane = threadIdx.x % 32;
  longlong2* st = stage + threadIdx.x / 32 * S;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const uint4* in4 = reinterpret_cast<const uint4*>(in);
  longlong2* out2 = reinterpret_cast<longlong2*>(out);
  // w: the warp's first vector; every lane takes the loop's turns alike
  for (int64_t w = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x - lane; w < nvec;
       w += stride) {
    if (w + lane < nvec) {
      union {
        uint4 u;
        N v[V];
      } x;
      x.u = in4[w + lane];
#pragma unroll
      for (int k = 0; k < V; k += 2)
        st[lane * (V / 2) + k / 2] = make_longlong2(carrier<N, Q>(x.v[k], q, lim),
                                                    carrier<N, Q>(x.v[k + 1], q, lim));
    }
    __syncwarp();
    const int64_t left = (nvec - w) * (V / 2);
    const int ns = left < S ? static_cast<int>(left) : S;
    for (int j = lane; j < ns; j += 32) out2[w * (V / 2) + j] = st[j];
    __syncwarp();
  }
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  for (int64_t i = nvec * V + t0; i < n; i += stride) out[i] = carrier<N, Q>(in[i], q, lim);
}

template <typename N, int Q>
void launch(const void* in, int64_t n, uint64_t q, uint64_t lim, void* out,
            cudaStream_t stream) {
  constexpr int V = 16 / sizeof(N);
  const bool aligned = reinterpret_cast<uintptr_t>(in) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int64_t nvec = aligned ? n / V : 0;
  const int64_t work = nvec > n - nvec * V ? nvec : n - nvec * V;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  quantize_kernel<N, Q><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const N*>(in), n, nvec, static_cast<Arith<N>>(q), static_cast<Arith<N>>(lim),
      static_cast<int64_t*>(out));
}

template <typename N>
void launch_step(const void* in, int64_t n, uint64_t q, uint64_t lim, void* out,
                 cudaStream_t stream) {
  switch (q) {
    case 2: launch<N, 2>(in, n, q, lim, out, stream); break;
    case 3: launch<N, 3>(in, n, q, lim, out, stream); break;
    case 4: launch<N, 4>(in, n, q, lim, out, stream); break;
    default: launch<N, 0>(in, n, q, lim, out, stream); break;
  }
}

}  // namespace

// K11.  in (n,) values of tbits bits, signed where is_signed; out (n,)
// int64; q the step, from 2 to the type's largest value; away: ties away
// from zero.
extern "C" int qb3_quantize(const void* in, int64_t n, int tbits, int is_signed, uint64_t q,
                            int away, void* out, void* stream) {
  if (n < 0 || q < 2 || (tbits != 8 && tbits != 16 && tbits != 32 && tbits != 64))
    return static_cast<int>(cudaErrorInvalidValue);
  const uint64_t top = tbits == 64 ? (is_signed ? ~0ull >> 1 : ~0ull)
                                   : (1ull << (tbits - (is_signed ? 1 : 0))) - 1;
  if (q > top) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    const uint64_t lim = away ? q - q / 2 : q / 2 + 1;
    const auto s = static_cast<cudaStream_t>(stream);
    switch (tbits * 2 + (is_signed ? 1 : 0)) {
      case 16: launch_step<uint8_t>(in, n, q, lim, out, s); break;
      case 17: launch_step<int8_t>(in, n, q, lim, out, s); break;
      case 32: launch_step<uint16_t>(in, n, q, lim, out, s); break;
      case 33: launch_step<int16_t>(in, n, q, lim, out, s); break;
      case 64: launch_step<uint32_t>(in, n, q, lim, out, s); break;
      case 65: launch_step<int32_t>(in, n, q, lim, out, s); break;
      case 128: launch_step<uint64_t>(in, n, q, lim, out, s); break;
      default: launch_step<int64_t>(in, n, q, lim, out, s); break;
    }
  }
  return static_cast<int>(cudaGetLastError());
}
