// K5a (wavefront8) and K5b (wavefront_wide) for qb3_tpu_torch, sm_90a.
//
// Replaces qb3_tpu/ops/wavefront_pallas.py: wavefront8 (_wavefront8_kernel)
// and wavefront_wide (_wavefront_wide_kernel), and, for the best-mode kinds,
// the XLA group decode that qb3_tpu runs after its serial walk
// (decode_groups_fused for u8/u16, decode_groups for u32/u64, in
// qb3_tpu/ops/decode.py).
//
// What they compute: the 16-value walk of one group from its register
// window.  The caller gathered each group's NREG stream words (regs, base =
// first value bit >> 5) and parsed its codeswitch, so a group arrives with
// `off`, the bit of its first value inside the window, its rung, its kind
// and, for CF and CF0 groups, its common factor cf.  Kinds (ops/decode.py
// K5_KIND): 0 all zero, 1 group-coded, 2 literal bits, 3 CF (group-coded,
// then the step restore and the multiply-back by cf), 4 CF0 (literal bits,
// each set one -> the mag-sign of -cf), 5 IDX (16 rung-2 index codes
// without the swap, then max index + 1 <= 8 uniques in the single-value
// context at the rung, each value taken from its unique); any other kind
// decodes as zero.  Group values are the group-context VLC at the rung
// (QB3decode.h:603-723); u64 includes the rung-63 65-bit long form.
// Output: (ngroups, 16) mag-sign values, u32 for K5a (u8 streams), u64 for
// K5b (u16 / u32 / u64 streams); CF and CF0 values are masked to the type
// for u8 / u16 and wrap at 64 bits for u32 / u64, as qb3_tpu's decodes do.
// The BASE-mode step restore of kind-1 groups stays with the caller; a CF
// group's restore must precede its multiply, so it runs here.
//
// Semantics: on kinds 0-2, those of the TPU kernels on any input in their
// domain (off in [0, 64), rung below the type's bit width): window words
// past NREG read as zero, K5a keeps a 64-bit accumulator refilled a word at
// a time (the uniques continue in it), K5b builds a 64-bit window at each
// value and each unique.  On the walk's groups the window holds the whole
// group from any bit phase (ops/decode._NREG_IX), so no value reads past it.
//
// Bound: latency.  A thread does ~16-24 dependent VLC decodes (tens of
// integer operations each) and moves NREG * 4 + 16 * (4 or 8) bytes.
//
// Design: one thread per group; its window row is read directly (the rows
// of a warp are contiguous, so the reads share cache lines), the
// accumulator is a native uint64_t, not the TPU's two u32 lanes, and no
// G_BLK padding is needed (a Mosaic tiling rule).  IDX groups take a branch
// of their own (the index codes, then the uniques), so a warp of fast-mode
// groups runs the kinds-0-2 walk alone, and CF / CF0 groups read cf only
// where the caller passed it.

#include <cuda_runtime.h>

#include <cstdint>

#include "vlc.cuh"

namespace {

constexpr int kThreads = 128;
// K5 kind codes (ops/decode.py K5_KIND)
constexpr int kZero = 0, kGroup = 1, kBits = 2, kCf = 3, kCf0 = 4, kIdx = 5;

__device__ __forceinline__ uint32_t reg(const uint32_t* row, int nreg, int k) {
  return (k >= 0 && k < nreg) ? __ldg(row + k) : 0u;
}

// CF multiply-back (after the step restore) and CF0 expansion of one
// group's values, masked to `mask` (all ones for u32 / u64).
template <typename T>
__device__ __forceinline__ void apply_cf(T (&vals)[16], int kind, int rung, uint64_t cf,
                                         uint64_t mask) {
  if (kind == kCf) {
    if (rung >= 1) qb3::step_restore(vals, rung);  // rung 0 only on garbage input
    const uint64_t c2 = cf << 1;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const uint64_t v = vals[i], s = v & 1ull;
      vals[i] = static_cast<T>((((v >> 1) + s) * c2 - s) & mask);
    }
  } else if (kind == kCf0) {
    const T neg = static_cast<T>((((cf - 1) << 1) | 1ull) & mask);
#pragma unroll
    for (int i = 0; i < 16; ++i) vals[i] = vals[i] ? neg : static_cast<T>(0);
  }
}

// Each index value of an IDX group replaced by its unique (an index above
// 7 takes unique 7, as qb3_tpu's clip does; rung-2 codes stop at 7).
template <typename T>
__device__ __forceinline__ void take_uniques(T (&vals)[16], const T (&uq)[8]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    T v = uq[7];
#pragma unroll
    for (int u = 0; u < 7; ++u) v = vals[i] == static_cast<T>(u) ? uq[u] : v;
    vals[i] = v;
  }
}

// The 16 codes of a u8 group from the accumulator: IDX's rung-2 index codes,
// or (IDX false) kinds 0-4's group-coded values or literal bits.  The two
// are separate instances so that a kinds-0-2 walk does no index decode.
template <bool IDX>
__device__ __forceinline__ void codes8(const uint32_t* row, int nreg, int rung, bool isg,
                                       bool isb, uint64_t& acc, int& navail, int& k,
                                       uint32_t (&vals)[16]) {
#pragma unroll
  for (int v0 = 0; v0 < 16; v0 += 3) {
    int shift = 0;
#pragma unroll
    for (int i = v0; i < (v0 + 3 < 16 ? v0 + 3 : 16); ++i) {
      const uint32_t ww = static_cast<uint32_t>(acc >> shift);
      int len;
      if (IDX) {
        vals[i] = static_cast<uint32_t>(qb3::vlc_plain64(ww, 2, &len));
        shift += len;
      } else {
        const uint32_t gv = qb3::vlc_group32(ww, rung, &len);
        vals[i] = isg ? gv : (isb ? (ww & 1u) : 0u);
        shift += isg ? len : (isb ? 1 : 0);
      }
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
}

__global__ void wavefront8_kernel(const uint32_t* __restrict__ regs, int64_t ngroups,
                                  int nreg, const int32_t* __restrict__ off_in,
                                  const int32_t* __restrict__ rung_in,
                                  const int32_t* __restrict__ kind_in,
                                  const uint64_t* __restrict__ cf_in,
                                  uint32_t* __restrict__ out) {
  const int64_t g = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (g >= ngroups) return;
  const uint32_t* row = regs + g * nreg;
  const int off = off_in[g], rung = rung_in[g], kind = kind_in[g];
  const bool isg = kind == kGroup || kind == kCf, isb = kind == kBits || kind == kCf0;
  const int sh = off & 31;
  int k = off >> 5;
  // 64-bit accumulator = (r0 | r1 << 32 | r2 << 64) >> sh
  uint64_t acc = (static_cast<uint64_t>(reg(row, nreg, k)) |
                  static_cast<uint64_t>(reg(row, nreg, k + 1)) << 32) >> sh;
  if (sh) acc |= static_cast<uint64_t>(reg(row, nreg, k + 2)) << (64 - sh);
  int navail = 64 - sh;
  k += 2;
  uint32_t vals[16];
  if (kind != kIdx) {
    codes8<false>(row, nreg, rung, isg, isb, acc, navail, k, vals);
    if (kind == kCf || kind == kCf0) apply_cf(vals, kind, rung, cf_in ? cf_in[g] : 0ull, 0xFFull);
  } else {
    codes8<true>(row, nreg, rung, false, false, acc, navail, k, vals);
    uint32_t maxidx = 0;
#pragma unroll
    for (int i = 0; i < 16; ++i) maxidx = vals[i] > maxidx ? vals[i] : maxidx;
    uint32_t uq[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      uq[u] = 0;
      if (static_cast<uint32_t>(u) <= maxidx) {
        // a unique is <= 9 bits and at least 27 are held
        int ul;
        uq[u] = static_cast<uint32_t>(
            qb3::vlc_single64(static_cast<uint32_t>(acc), rung, &ul));
        acc >>= ul;
        navail -= ul;
        if (navail < 27) {
          acc |= static_cast<uint64_t>(reg(row, nreg, k)) << navail;
          navail += 32;
          ++k;
        }
      }
    }
    take_uniques(vals, uq);
  }
  uint4* dst = reinterpret_cast<uint4*>(out + g * 16);
#pragma unroll
  for (int q = 0; q < 4; ++q)
    dst[q] = make_uint4(vals[4 * q], vals[4 * q + 1], vals[4 * q + 2], vals[4 * q + 3]);
}

// A fresh 64-bit window at bit `off` of the row, from three window words;
// *r2 receives the third word (the rung-63 long form's 65th bit).
__device__ __forceinline__ uint64_t window64(const uint32_t* row, int nreg, int off,
                                             uint32_t* r2) {
  const int wi = off >> 5, sh = off & 31;
  *r2 = reg(row, nreg, wi + 2);
  uint64_t w = (static_cast<uint64_t>(reg(row, nreg, wi)) |
                static_cast<uint64_t>(reg(row, nreg, wi + 1)) << 32) >> sh;
  if (sh) w |= static_cast<uint64_t>(*r2) << (64 - sh);
  return w;
}

// The 16 codes of a u16 / u32 / u64 group, a fresh window at each: IDX's
// rung-2 index codes, or (IDX false) kinds 0-4's group-coded values or
// literal bits.  Returns the bit after the last code.
template <int TBITS, bool IDX>
__device__ __forceinline__ int codes_wide(const uint32_t* row, int nreg, int off, int rung,
                                          bool isg, bool isb, uint64_t (&vals)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    uint32_t r2;
    const uint64_t w = window64(row, nreg, off, &r2);
    int len;
    if (IDX) {
      vals[i] = qb3::vlc_plain64(w, 2, &len);
      off += len;
      continue;
    }
    uint64_t gv;
    if (TBITS == 16) {
      gv = qb3::vlc_group32(static_cast<uint32_t>(w), rung, &len);
    } else {
      gv = qb3::vlc64(w, rung, &len);
      // rung-63 long form: the 65th stream bit is value bit 62
      if (TBITS == 64 && len == 65) gv |= static_cast<uint64_t>((r2 >> (off & 31)) & 1u) << 62;
    }
    vals[i] = isg ? gv : (isb ? (w & 1ull) : 0ull);
    off += isg ? len : (isb ? 1 : 0);
  }
  return off;
}

template <int TBITS>
__global__ void wavefront_wide_kernel(const uint32_t* __restrict__ regs, int64_t ngroups,
                                      int nreg, const int32_t* __restrict__ off_in,
                                      const int32_t* __restrict__ rung_in,
                                      const int32_t* __restrict__ kind_in,
                                      const uint64_t* __restrict__ cf_in,
                                      uint64_t* __restrict__ out) {
  const int64_t g = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (g >= ngroups) return;
  const uint32_t* row = regs + g * nreg;
  const int rung = rung_in[g], kind = kind_in[g];
  const bool isg = kind == kGroup || kind == kCf, isb = kind == kBits || kind == kCf0;
  uint64_t vals[16];
  if (kind != kIdx) {
    codes_wide<TBITS, false>(row, nreg, off_in[g], rung, isg, isb, vals);
    if (kind == kCf || kind == kCf0)
      apply_cf(vals, kind, rung, cf_in ? cf_in[g] : 0ull, TBITS == 16 ? 0xFFFFull : ~0ull);
  } else {
    int off = codes_wide<TBITS, true>(row, nreg, off_in[g], rung, false, false, vals);
    uint64_t maxidx = 0;
#pragma unroll
    for (int i = 0; i < 16; ++i) maxidx = vals[i] > maxidx ? vals[i] : maxidx;
    uint64_t uq[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      uq[u] = 0;
      if (static_cast<uint64_t>(u) <= maxidx) {
        uint32_t r2;
        const uint64_t w = window64(row, nreg, off, &r2);
        int ul;
        // u16 reads its uniques from the window's low 32 bits, as
        // decode_groups_fused does; u32 / u64 from all 64
        uq[u] = qb3::vlc_single64(TBITS == 16 ? (w & 0xFFFFFFFFull) : w, rung, &ul);
        off += ul;
      }
    }
    take_uniques(vals, uq);
  }
  ulonglong2* dst = reinterpret_cast<ulonglong2*>(out + g * 16);
#pragma unroll
  for (int q = 0; q < 8; ++q) dst[q] = make_ulonglong2(vals[2 * q], vals[2 * q + 1]);
}

unsigned blocks_for(int64_t n) { return static_cast<unsigned>((n + kThreads - 1) / kThreads); }

}  // namespace

// K5a.  regs (ngroups, nreg) u32; off / rung / kind (ngroups,) int32; cf
// (ngroups,) u64 or null (read for kinds 3 and 4 only; null reads 0); out
// (ngroups, 16) u32.
extern "C" int qb3_wavefront8(const void* regs, int64_t ngroups, int nreg, const void* off,
                              const void* rung, const void* kind, const void* cf, void* out,
                              void* stream) {
  if (nreg < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (ngroups > 0)
    wavefront8_kernel<<<blocks_for(ngroups), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(regs), ngroups, nreg, static_cast<const int32_t*>(off),
        static_cast<const int32_t*>(rung), static_cast<const int32_t*>(kind),
        static_cast<const uint64_t*>(cf), static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// K5b.  As K5a for tbits 16 / 32 / 64; out (ngroups, 16) u64.
extern "C" int qb3_wavefront_wide(const void* regs, int64_t ngroups, int nreg, int tbits,
                                  const void* off, const void* rung, const void* kind,
                                  const void* cf, void* out, void* stream) {
  if (nreg < 1 || (tbits != 16 && tbits != 32 && tbits != 64))
    return static_cast<int>(cudaErrorInvalidValue);
  if (ngroups > 0) {
    auto kern = tbits == 16 ? wavefront_wide_kernel<16>
              : tbits == 32 ? wavefront_wide_kernel<32> : wavefront_wide_kernel<64>;
    kern<<<blocks_for(ngroups), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(regs), ngroups, nreg, static_cast<const int32_t*>(off),
        static_cast<const int32_t*>(rung), static_cast<const int32_t*>(kind),
        static_cast<const uint64_t*>(cf), static_cast<uint64_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
