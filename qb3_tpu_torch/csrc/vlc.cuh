// Shared QB3 decode primitives for the CUDA kernels of qb3_tpu_torch.
//
// Ported from the JAX package's arithmetic decoders: _vlc32 / _vlc32w
// (qb3_tpu/ops/wavefront_pallas.py), _vlc_decode_arith and dsw_arith
// (qb3_tpu/ops/decode.py).  On a TPU these work on int32 lanes because
// Mosaic has no 64-bit integers; here they take native unsigned words.
#pragma once

#include <cstdint>

namespace qb3 {

// Group-context VLC decode at `rung` (1..31) from the low stream bits `w`:
// the base 3-range code plus the middle swap of the tabled rungs (rung 1:
// 1<->2, rung 2: 3<->4, rungs 3..7: 2^r-1 <-> 2^r; QB3decode.h:21-23).
// Rung 0 is clamped to 1, as the callers mask rung-0 groups anyway.
__device__ __forceinline__ uint32_t vlc_group32(uint32_t w, int rung, int* len) {
  const int r = rung < 1 ? 1 : rung;
  const uint32_t rbit = 1u << r;
  const uint32_t vmask = rbit - 1;
  const bool shrt = (w & 1u) == 0;
  const uint32_t n = (w >> 1) & 1u;
  const uint32_t v2 = (w >> 2) & vmask;
  uint32_t v = shrt ? (w & vmask) >> 1 : (n == 0 ? v2 | (rbit >> 1) : v2 | rbit);
  *len = shrt ? r : r + 1 + static_cast<int>(n);
  if (r <= 7) {
    const uint32_t a = r == 1 ? 1u : (r == 2 ? 3u : rbit - 1);
    v = v == a ? a + 1 : (v == a + 1 ? a : v);
  }
  return v;
}

// Codeswitch decode (the DSW table, QB3decode.h:613-618) from the stream
// bits AFTER the change flag.  Returns the rung delta on ubits bits and
// sets *len to the code length including the flag.
__device__ __forceinline__ int dsw(uint64_t w1, int ubits, int* len) {
  const int r = ubits - 1;
  const uint64_t rbit = 1ull << r;
  const uint64_t vmask = rbit - 1;
  const bool shrt = (w1 & 1ull) == 0;
  const uint64_t n = (w1 >> 1) & 1ull;
  const uint64_t v = shrt ? (w1 & vmask) >> 1
                          : (n == 0 ? ((w1 >> 2) & vmask) | (rbit >> 1)
                                    : ((w1 >> 2) & vmask) | rbit);
  *len = (shrt ? r : r + 1 + static_cast<int>(n)) + 1;
  const int mag = static_cast<int>(v >> 1);
  return (v & 1ull) ? (-(mag + 1)) & ((1 << ubits) - 1)
                    : (mag + 1) & ((1 << (ubits - 1)) - 1);
}

}  // namespace qb3
