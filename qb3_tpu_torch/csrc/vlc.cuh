// Shared QB3 VLC primitives for the CUDA kernels of qb3_tpu_torch.
//
// Ported from the JAX package's arithmetic decoders: _vlc32 / _vlc32w /
// _vlc64 (qb3_tpu/ops/wavefront_pallas.py), _vlc_decode_arith,
// _vlc_decode_plain, _vlc_decode_single, dsw_arith and the step restore
// (qb3_tpu/ops/decode.py), and from its encoder
// _enc_pair (qb3_tpu/ops/encode_pallas.py).  On a TPU these work on int32
// lanes because Mosaic has no 64-bit integers; here they take native
// unsigned words.
#pragma once

#include <cstdint>

namespace qb3 {

// Group-context VLC decode at `rung` (1..31) from the low stream bits `w`:
// the base 3-range code plus the middle swap of the tabled rungs (rung 1:
// 1<->2, rung 2: 3<->4, rungs 3..7: 2^r-1 <-> 2^r; QB3decode.h:21-23).
// Rung 0 is clamped to 1, as the callers mask rung-0 groups anyway.  With
// swap false it is the plain code (_vlc_decode_plain), as index codes are
// read at rung 2.
__device__ __forceinline__ uint32_t vlc_group32(uint32_t w, int rung, int* len,
                                                bool swap = true) {
  const int r = rung < 1 ? 1 : rung;
  const uint32_t rbit = 1u << r;
  const uint32_t vmask = rbit - 1;
  const bool shrt = (w & 1u) == 0;
  const uint32_t n = (w >> 1) & 1u;
  const uint32_t v2 = (w >> 2) & vmask;
  uint32_t v = shrt ? (w & vmask) >> 1 : (n == 0 ? v2 | (rbit >> 1) : v2 | rbit);
  *len = shrt ? r : r + 1 + static_cast<int>(n);
  if (swap && r <= 7) {
    const uint32_t a = r == 1 ? 1u : (r == 2 ? 3u : rbit - 1);
    v = v == a ? a + 1 : (v == a + 1 ? a : v);
  }
  return v;
}

// Group-context VLC decode at `rung` (1..63) from a 64-bit stream window
// `w`, the counterpart of _vlc64 (wavefront_pallas.py) on a native word.
// Sets *len up to 65: the rung-63 long form's 65th bit (value bit 62) lies
// past the window, and the caller ORs it in.  The middle swap applies to the
// tabled rungs only, and only where the value fits 32 bits (vhi == 0); with
// swap false it is vlc_plain64.
__device__ __forceinline__ uint64_t vlc64(uint64_t w, int rung, int* len, bool swap = true) {
  const int r = rung < 1 ? 1 : rung;
  const uint64_t rbit = 1ull << r;
  const uint64_t vmask = rbit - 1;
  const bool shrt = (w & 1ull) == 0;
  const int n = static_cast<int>((w >> 1) & 1ull);
  uint64_t v = shrt ? (w & vmask) >> 1 : ((w >> 2) & vmask) | (n ? rbit : rbit >> 1);
  *len = shrt ? r : r + 1 + n;
  if (swap && r <= 7 && (v >> 32) == 0) {
    const uint64_t a = r == 1 ? 1ull : (r == 2 ? 3ull : rbit - 1);
    v = v == a ? a + 1 : (v == a + 1 ? a : v);
  }
  return v;
}

// Plain VLC decode at `rung` (0 is taken as 1) from a 64-bit stream window
// `w`: the base 3-range code with no swap, the counterpart of
// _vlc_decode_plain (qb3_tpu/ops/decode.py).  Index codes are read with it
// at rung 2 (the IDX_DEC table).  Sets *len up to 65 at rung 63.
__device__ __forceinline__ uint64_t vlc_plain64(uint64_t w, int rung, int* len) {
  const int r = rung < 1 ? 1 : rung;
  const uint64_t rbit = 1ull << r;
  const uint64_t vmask = rbit - 1;
  const bool shrt = (w & 1ull) == 0;
  const int n = static_cast<int>((w >> 1) & 1ull);
  *len = shrt ? r : r + 1 + n;
  return shrt ? (w & vmask) >> 1 : ((w >> 2) & vmask) | (n ? rbit : rbit >> 1);
}

// Single-value context decode (CF values, index uniques; the DEC_SINGLE
// table and its computed rungs), the counterpart of _vlc_decode_single /
// _dec_value(..., single): rung 0 is one literal bit, rungs 3..7 swap the
// middle pair 2^r-1 <-> 2^r, other rungs decode plain.  No rung-63 extra
// bit: *len may be 65, and the value keeps what the 64 bits give.
__device__ __forceinline__ uint64_t vlc_single64(uint64_t w, int rung, int* len) {
  if (rung == 0) {
    *len = 1;
    return w & 1ull;
  }
  uint64_t v = vlc_plain64(w, rung, len);
  if (rung >= 3 && rung <= 7) {
    const uint64_t a = (1ull << rung) - 1;
    v = v == a ? a + 1 : (v == a + 1 ? a : v);
  }
  return v;
}

// Group-context VLC encode of the mag-sign value `v` at `rung` (1..63), the
// counterpart of _enc_pair (encode_pallas.py) and of value_codes_arith
// (qb3_tpu_torch/ops/encode.py): the middle swap of the tabled rungs (rung
// 1: 1<->2, rung 2: 3<->4, rungs 3..7: 2^r-1 <-> 2^r), then the base
// 3-range code (QB3encode.h:132-141).  Returns the low 64 code bits and sets
// *len up to 65: the rung-63 long form's bit 64 is value bit 62, which the
// caller emits after the 64 bits returned.
__device__ __forceinline__ uint64_t vlc_encode(uint64_t v, int rung, int* len) {
  const int r = rung < 1 ? 1 : rung;
  if (r <= 7) {
    const uint64_t a = r == 1 ? 1ull : (r == 2 ? 3ull : (1ull << r) - 1);
    v = v == a ? a + 1 : (v == a + 1 ? a : v);
  }
  const int top = static_cast<int>((v >> r) & 1ull);
  const int nxt = static_cast<int>((v >> (r - 1)) & 1ull);
  *len = r + top + (top | nxt);
  if (top) return ((v ^ (1ull << r)) << 2) | 3ull;        // long: r + 2 bits
  if (nxt) return ((v ^ (1ull << (r - 1))) << 2) | 1ull;  // nominal: r + 1
  return v << 1;                                         // short: r
}

// BASE-mode step-bit restore of one decoded group (QB3decode.h:285-289):
// when the rung bits of the 16 values form the pattern 1*0*, flip bit `rung`
// of value #ones.  The caller applies it to group-coded groups (rung >= 1).
template <typename T>
__device__ __forceinline__ void step_restore(T (&vals)[16], int rung) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) acc |= static_cast<uint32_t>((vals[i] >> rung) & 1u) << i;
  const int ones = acc ? 32 - __clz(acc) : 0;
  if ((acc & (acc + 1)) == 0 && ones < 16) {
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (i == ones) vals[i] ^= static_cast<T>(1) << rung;
  }
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
