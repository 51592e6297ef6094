// K5a (wavefront8) and K5b (wavefront_wide) for qb3_tpu_torch, sm_90a.
//
// Replaces qb3_tpu/ops/wavefront_pallas.py: wavefront8 (_wavefront8_kernel)
// and wavefront_wide (_wavefront_wide_kernel).
//
// What they compute: the 16-value walk of one group from its register
// window.  The caller gathered each group's NREG stream words (regs, base =
// group start bit >> 5) and parsed its codeswitch, so a group arrives with
// `off`, the bit of its first value inside the window, its rung, and its
// kind (1 group-coded, 2 literal bits, 0 all zero).  Values are the
// group-context VLC at the rung (QB3decode.h:603-723); u64 includes the
// rung-63 65-bit long form.  Output: (ngroups, 16) mag-sign values, u32
// for K5a (u8 streams), u64 for K5b (u16 / u32 / u64 streams).
//
// Semantics: those of the TPU kernels on any input in their domain (off in
// [0, 64), kind in {0, 1, 2}, rung below the type's bit width): window words
// past NREG read as zero, K5a keeps a 64-bit accumulator refilled a word at
// a time, K5b builds a 64-bit window at each value.  They run on valid
// streams only (the fused=None branch of ops/decode.decode_indexed_narrow).
//
// Bound: latency.  A thread does ~16 dependent VLC decodes (tens of integer
// operations each) and moves NREG * 4 + 16 * (4 or 8) bytes.
//
// Design: one thread per group; its window row is read directly (the rows
// of a warp are contiguous, so the reads share cache lines), the
// accumulator is a native uint64_t, not the TPU's two u32 lanes, and no
// G_BLK padding is needed (a Mosaic tiling rule).

#include <cuda_runtime.h>

#include <cstdint>

#include "vlc.cuh"

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ uint32_t reg(const uint32_t* row, int nreg, int k) {
  return (k >= 0 && k < nreg) ? __ldg(row + k) : 0u;
}

__global__ void wavefront8_kernel(const uint32_t* __restrict__ regs, int64_t ngroups,
                                  int nreg, const int32_t* __restrict__ off_in,
                                  const int32_t* __restrict__ rung_in,
                                  const int32_t* __restrict__ kind_in,
                                  uint32_t* __restrict__ out) {
  const int64_t g = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (g >= ngroups) return;
  const uint32_t* row = regs + g * nreg;
  const int off = off_in[g], rung = rung_in[g], kind = kind_in[g];
  const bool isg = kind == 1, isb = kind == 2;
  const int sh = off & 31;
  int k = off >> 5;
  // 64-bit accumulator = (r0 | r1 << 32 | r2 << 64) >> sh
  uint64_t acc = (static_cast<uint64_t>(reg(row, nreg, k)) |
                  static_cast<uint64_t>(reg(row, nreg, k + 1)) << 32) >> sh;
  if (sh) acc |= static_cast<uint64_t>(reg(row, nreg, k + 2)) << (64 - sh);
  int navail = 64 - sh;
  k += 2;
  uint32_t vals[16];
#pragma unroll
  for (int v0 = 0; v0 < 16; v0 += 3) {
    int shift = 0;
#pragma unroll
    for (int i = v0; i < (v0 + 3 < 16 ? v0 + 3 : 16); ++i) {
      const uint32_t ww = static_cast<uint32_t>(acc >> shift);
      int gl;
      const uint32_t gv = qb3::vlc_group32(ww, rung, &gl);
      vals[i] = isg ? gv : (isb ? (ww & 1u) : 0u);
      shift += isg ? gl : (isb ? 1 : 0);
    }
    // consume and refill: a macro step uses <= 27 bits, less than one word
    acc >>= shift;
    navail -= shift;
    if (navail < 27) {
      acc |= static_cast<uint64_t>(reg(row, nreg, k)) << navail;
      navail += 32;
      ++k;
    }
  }
  uint4* dst = reinterpret_cast<uint4*>(out + g * 16);
#pragma unroll
  for (int q = 0; q < 4; ++q)
    dst[q] = make_uint4(vals[4 * q], vals[4 * q + 1], vals[4 * q + 2], vals[4 * q + 3]);
}

template <int TBITS>
__global__ void wavefront_wide_kernel(const uint32_t* __restrict__ regs, int64_t ngroups,
                                      int nreg, const int32_t* __restrict__ off_in,
                                      const int32_t* __restrict__ rung_in,
                                      const int32_t* __restrict__ kind_in,
                                      uint64_t* __restrict__ out) {
  const int64_t g = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (g >= ngroups) return;
  const uint32_t* row = regs + g * nreg;
  int off = off_in[g];
  const int rung = rung_in[g], kind = kind_in[g];
  const bool isg = kind == 1, isb = kind == 2;
  uint64_t vals[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    // a fresh 64-bit window at each value, from three window words
    const int wi = off >> 5, sh = off & 31;
    const uint32_t r2 = reg(row, nreg, wi + 2);
    uint64_t w = (static_cast<uint64_t>(reg(row, nreg, wi)) |
                  static_cast<uint64_t>(reg(row, nreg, wi + 1)) << 32) >> sh;
    if (sh) w |= static_cast<uint64_t>(r2) << (64 - sh);
    int gl;
    uint64_t gv;
    if (TBITS == 16) {
      gv = qb3::vlc_group32(static_cast<uint32_t>(w), rung, &gl);
    } else {
      gv = qb3::vlc64(w, rung, &gl);
      // rung-63 long form: the 65th stream bit is value bit 62
      if (TBITS == 64 && gl == 65) gv |= static_cast<uint64_t>((r2 >> sh) & 1u) << 62;
    }
    vals[i] = isg ? gv : (isb ? (w & 1ull) : 0ull);
    off += isg ? gl : (isb ? 1 : 0);
  }
  ulonglong2* dst = reinterpret_cast<ulonglong2*>(out + g * 16);
#pragma unroll
  for (int q = 0; q < 8; ++q) dst[q] = make_ulonglong2(vals[2 * q], vals[2 * q + 1]);
}

unsigned blocks_for(int64_t n) { return static_cast<unsigned>((n + kThreads - 1) / kThreads); }

}  // namespace

// K5a.  regs (ngroups, nreg) u32; off / rung / kind (ngroups,) int32;
// out (ngroups, 16) u32.
extern "C" int qb3_wavefront8(const void* regs, int64_t ngroups, int nreg, const void* off,
                              const void* rung, const void* kind, void* out, void* stream) {
  if (nreg < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (ngroups > 0)
    wavefront8_kernel<<<blocks_for(ngroups), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(regs), ngroups, nreg, static_cast<const int32_t*>(off),
        static_cast<const int32_t*>(rung), static_cast<const int32_t*>(kind),
        static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// K5b.  As K5a for tbits 16 / 32 / 64; out (ngroups, 16) u64.
extern "C" int qb3_wavefront_wide(const void* regs, int64_t ngroups, int nreg, int tbits,
                                  const void* off, const void* rung, const void* kind,
                                  void* out, void* stream) {
  if (nreg < 1 || (tbits != 16 && tbits != 32 && tbits != 64))
    return static_cast<int>(cudaErrorInvalidValue);
  if (ngroups > 0) {
    auto kern = tbits == 16 ? wavefront_wide_kernel<16>
              : tbits == 32 ? wavefront_wide_kernel<32> : wavefront_wide_kernel<64>;
    kern<<<blocks_for(ngroups), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(regs), ngroups, nreg, static_cast<const int32_t*>(off),
        static_cast<const int32_t*>(rung), static_cast<const int32_t*>(kind),
        static_cast<uint64_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
