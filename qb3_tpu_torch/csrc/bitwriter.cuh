// The serial bit writer that K1 (pack.cu) and K8 (encode_image.cu) share.
//
// One thread writes one group's bits at the group's start bit.  The stream
// is little-endian at bit level: bit p lives in 32-bit word p >> 5 at
// weight 1 << (p & 31).  Neighbouring groups share words but never bits, so
// ORing each word into the zero-filled stream is exact in any order; the
// writer keeps the current word in a register and flushes it with one
// atomicOr when it moves on.  Words at or past n_words are dropped, like the
// JAX package's scatter.
#pragma once

#include <cstdint>

namespace qb3 {

struct BitWriter {
  uint32_t* out;
  int64_t n_words;
  int64_t p;    // next stream bit
  int64_t cur;  // word held in acc
  uint32_t acc;

  __device__ BitWriter(uint32_t* out_, int64_t n_words_, int64_t start)
      : out(out_), n_words(n_words_), p(start), cur(start >> 5), acc(0) {}

  // Append the low `len` bits of `code` (0 <= len <= 64).
  __device__ __forceinline__ void put(uint64_t code, int len) {
    while (len > 0) {
      const int64_t wi = p >> 5;
      const int sh = static_cast<int>(p & 31);
      const int take = len < 32 - sh ? len : 32 - sh;
      if (wi != cur) {
        flush();
        cur = wi;
      }
      acc |= static_cast<uint32_t>(code & ((1ull << take) - 1)) << sh;
      code >>= take;
      len -= take;
      p += take;
    }
  }

  // Write out the word held; call once after the last put.
  __device__ __forceinline__ void flush() {
    if (acc && cur < n_words) atomicOr(out + cur, acc);
    acc = 0;
  }
};

}  // namespace qb3
