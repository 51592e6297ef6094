// The per-group arithmetic and the raster geometry that K9 (phase_a.cu, the
// fast phase A) and K10 (phase_a_best.cu, the best modes' phase A) share,
// for sm_90.
//
// Both kernels take one group (a raster block x a band) a thread and a run
// of consecutive raster blocks of one block-row a CTA.  Values, masks and
// codes are 32-bit up to u16 (codes up to u16 reach 17 bits) and 64-bit
// only where the width needs them.

#pragma once

#include <cstdint>
#include <type_traits>

namespace qb3 {

template <int TB>
using Val = typename std::conditional<TB == 64, uint64_t, uint32_t>::type;
template <int TB>
using Code = typename std::conditional<TB <= 16, uint32_t, uint64_t>::type;

template <int TB>
__device__ __forceinline__ Val<TB> wrap(Val<TB> v) {
  if constexpr (TB < 32) return v & ((Val<TB>(1) << TB) - 1);
  return v;
}

// two's complement -> mag-sign with the sign in bit 0 (QB3common.h:127-130)
template <int TB>
__device__ __forceinline__ Val<TB> mags(Val<TB> v) {
  const Val<TB> sign = (v >> (TB - 1)) & 1;
  return wrap<TB>((v << 1) ^ (Val<TB>(0) - sign));
}

// floor(log2(v)) of a non-zero value
__device__ __forceinline__ int topbit(uint32_t v) { return 31 - __clz(v); }
__device__ __forceinline__ int topbit(uint64_t v) { return 63 - __clzll(v); }

__host__ __device__ constexpr int ubits_of(int tb) {
  return tb == 8 ? 3 : (tb == 16 ? 4 : (tb == 32 ? 5 : 6));
}

// Codeswitch from oldrung to rung (the CSW table as csw_arith computes it):
// delta 0 is one 0 bit, otherwise a 1 bit then the base VLC of the biased
// mag-sign delta at rung ubits - 1.
template <int TB>
__device__ __forceinline__ uint32_t codeswitch(int rung, int oldrung, int* len) {
  constexpr int ub = ubits_of(TB), r = ub - 1, sb = 1 << r;
  const int d = (rung - oldrung) & ((1 << ub) - 1);
  if (d == 0) {
    *len = 1;
    return 0;
  }
  const int msv = (d & sb) ? 2 * ((1 << ub) - d) - 1 : 2 * ((d - 1) & (sb - 1));
  const int nxt = (msv >> (r - 1)) & 1, top = msv >> r;
  *len = r + top + (top | nxt) + 1;
  const uint32_t m = static_cast<uint32_t>(msv);
  const uint32_t code = top ? ((m ^ sb) << 2) | 3u : (nxt ? ((m ^ (sb >> 1)) << 2) | 1u : m << 1);
  return (code << 1) | 1u;
}

// Group-context VLC of the mag-sign value v at rung r >= 1: the middle swap
// of the tabled rungs (rung 1: 1<->2, rung 2: 3<->4, rungs 3..7: 2^r-1 <->
// 2^r), then the base 3-range code (QB3encode.h:132-141); *len up to 65.
template <int TB>
__device__ __forceinline__ Code<TB> vlc(Val<TB> v, int r, int* len) {
  using V = Val<TB>;
  using C = Code<TB>;
  if (r <= 7) {
    const V a = r == 1 ? V(1) : (r == 2 ? V(3) : (V(1) << r) - 1);
    v = v == a ? a + 1 : (v == a + 1 ? a : v);
  }
  const int top = static_cast<int>((v >> r) & 1);
  const int nxt = static_cast<int>((v >> (r - 1)) & 1);
  *len = r + top + (top | nxt);
  if (top) return (static_cast<C>(v ^ (V(1) << r)) << 2) | 3;
  if (nxt) return (static_cast<C>(v ^ (V(1) << (r - 1))) << 2) | 1;
  return static_cast<C>(v) << 1;
}

// The BASE step flip (QB3encode.h:169-176): when the bits at rung r of the
// 16 values in scan order form 1*0* with `ones` set bits, value ones - 1
// has its bit r flipped.  Returns the flip as a mask over the values (an
// index into a register array would put it in memory).
template <int TB>
__device__ __forceinline__ uint32_t step_flip(const Val<TB> (&m)[16], int r) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) acc |= static_cast<uint32_t>((m[i] >> r) & 1) << i;
  return acc != 0 && (acc & (acc + 1)) == 0 ? (acc + 1) >> 1 : 0u;  // the top set bit
}

struct Geometry {
  int64_t H, W;
  int C, nby, nbx;
  int nbk, chunks;  // raster blocks a CTA takes, CTAs a block-row
  uint64_t order;
  // origin of block-row by / block-column bx: the last one shifted to fit
  __device__ __forceinline__ int64_t oy(int by) const { return by == nby - 1 ? H - 4 : 4ll * by; }
  __device__ __forceinline__ int64_t ox(int bx) const { return bx == nbx - 1 ? W - 4 : 4ll * bx; }
  // curve lane i's (dy, dx), as the nibble dy << 2 | dx
  __device__ __forceinline__ int lane(int i) const {
    return static_cast<int>((order >> (60 - 4 * i)) & 15);
  }
};

// The geometry of tiles H x W x C, in runs of equal length of at most `most`
// groups: as few CTAs a block-row as that allows (one raster block a CTA
// where C > most).
inline Geometry make_geometry(int H, int W, int C, uint64_t order, int most) {
  Geometry geo;
  geo.H = H;
  geo.W = W;
  geo.C = C;
  geo.nby = (H + 3) / 4;
  geo.nbx = (W + 3) / 4;
  geo.order = order;
  const int nbk = C >= most ? 1 : most / C;
  geo.chunks = (geo.nbx + nbk - 1) / nbk;
  geo.nbk = (geo.nbx + geo.chunks - 1) / geo.chunks;
  geo.chunks = (geo.nbx + geo.nbk - 1) / geo.nbk;
  return geo;
}

// Value i (curve order) of band c of raster block bb of tile t, less its
// core band's, read from device memory (the halo).
template <int TB>
__device__ __forceinline__ Val<TB> halo_value(const int64_t* __restrict__ img, Geometry g,
                                              int64_t t, int64_t bb, int i, int c, int cb) {
  const int by = static_cast<int>(bb / g.nbx), bx = static_cast<int>(bb - (bb / g.nbx) * g.nbx);
  const int nib = g.lane(i);
  const int64_t at = ((t * g.H + g.oy(by) + (nib >> 2)) * g.W + g.ox(bx) + (nib & 3)) * g.C;
  const Val<TB> v = static_cast<Val<TB>>(img[at + c]);
  return cb == c ? wrap<TB>(v) : wrap<TB>(v - static_cast<Val<TB>>(img[at + cb]));
}

// The last value and the rung of raster block tb0 of tile t, band c, from
// device memory: the state a CTA's first block takes from the block before
// its run.  tb0 < 0 (the tile's first run) takes the entry state.
template <int TB>
__device__ __forceinline__ void halo_state(const int64_t* __restrict__ img, Geometry g, int64_t t,
                                           int64_t tb0, int c, int cb, int64_t prev_state,
                                           int prev_run, Val<TB>* last, int* rung) {
  if (tb0 < 0) {
    *last = static_cast<Val<TB>>(prev_state);
    *rung = prev_run;
    return;
  }
  Val<TB> p = tb0 == 0 ? static_cast<Val<TB>>(prev_state)
                       : halo_value<TB>(img, g, t, tb0 - 1, 15, c, cb);
  Val<TB> bits = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const Val<TB> v = halo_value<TB>(img, g, t, tb0, i, c, cb);
    bits |= mags<TB>(wrap<TB>(v - p));
    p = v;
  }
  *last = p;
  *rung = topbit(bits | 1);
}

// Stage the four row segments of a run (4 * span values each, from column
// xlo of block-row by of tile t) in shared memory at the values' width,
// coalesced: every thread of the CTA.
template <int TB>
__device__ __forceinline__ void stage_rows(const int64_t* __restrict__ img, Geometry g, int64_t t,
                                           int by, int64_t xlo, int span, Val<TB>* s_in) {
  const int tid = threadIdx.x, nthr = blockDim.x;
  for (int dy = 0; dy < 4; ++dy) {
    const int64_t* src = img + ((t * g.H + g.oy(by) + dy) * g.W + xlo) * g.C;
    Val<TB>* dst = s_in + dy * span;
    int j = tid;
    for (; j + 3 * nthr < span; j += 4 * nthr) {
      const int64_t a = src[j], b = src[j + nthr], c = src[j + 2 * nthr], d = src[j + 3 * nthr];
      dst[j] = static_cast<Val<TB>>(a);
      dst[j + nthr] = static_cast<Val<TB>>(b);
      dst[j + 2 * nthr] = static_cast<Val<TB>>(c);
      dst[j + 3 * nthr] = static_cast<Val<TB>>(d);
    }
    for (; j < span; j += nthr) dst[j] = static_cast<Val<TB>>(src[j]);
  }
}

__host__ __device__ constexpr uint32_t round16(uint32_t bytes) { return (bytes + 15) / 16 * 16; }

}  // namespace qb3
