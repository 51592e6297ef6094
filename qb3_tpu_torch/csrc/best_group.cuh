// One group's best-mode encoding for K10 (phase_a_best.cu): the plain, CF
// and index candidates of encode_best_blocks (ops/encode_best.py) for a
// raster block x band, in registers, and the symbols of the one it chooses.
//
// The arithmetic follows the twin's formulas; only the forms differ: a
// binary GCD where the twin takes a tree of torch.gcd, a rank count over at
// most 8 uniques where it takes a stable sort, a mask for the step flip.
// Up to u16 every code fits 32 bits (17 bits at most); codes of u32 and u64
// values take 64.

#pragma once

#include <cstdint>

#include "phase_a.cuh"

namespace qb3 {

constexpr int kNormal = 0, kZero = 1, kBits = 2, kCf = 3, kCf0 = 4, kIdx = 5;  // offsets.py

// symbols a group: S0, S1, S2, the 16 values (each with its 65th bit after
// it at u64), the 8 uniques
template <int TB>
__host__ __device__ constexpr int best_nsym() { return TB == 64 ? 43 : 27; }
template <int TB>
constexpr int kStep = TB == 64 ? 2 : 1;  // symbols a value
template <int TB>
constexpr int kUniq = 3 + 16 * kStep<TB>;  // the first unique's symbol
// SIGNAL (tables.SIGNAL): the ubits + 2 bits 2^(ubits + 2) - 9
template <int TB>
constexpr int kSigLen = ubits_of(TB) + 2;
template <int TB>
constexpr uint32_t kSigCode = (1u << kSigLen<TB>) - 9;

__device__ __forceinline__ int ctz(uint32_t v) { return __ffs(v) - 1; }
__device__ __forceinline__ int ctz(uint64_t v) { return __ffsll(v) - 1; }

// Binary GCD of unsigned values; gcd(0, b) = b.  Unsigned, it is exact on
// the u64 magnitude 2^63 (group_gcd's rule: the lowest set bit of the other).
template <class V>
__device__ __forceinline__ V gcd(V a, V b) {
  if (a == 0) return b;
  if (b == 0) return a;
  const int k = ctz(a | b);
  a >>= ctz(a);
  do {
    b >>= ctz(b);
    if (a > b) {
      const V s = a;
      a = b;
      b = s;
    }
    b -= a;
  } while (b != 0);
  return a << k;
}

// Codeswitch of a rung delta without its change flag, the no-change form
// replaced by the SIGNAL long form (_cs_or_signal then _flagless).
template <int TB>
__device__ __forceinline__ uint32_t flagless_cs(int d, int* len) {
  d &= (1 << ubits_of(TB)) - 1;
  if (d == 0) {
    *len = kSigLen<TB> - 1;
    return kSigCode<TB> >> 1;
  }
  int l;
  const uint32_t c = codeswitch<TB>(d, 0, &l);
  *len = l - 1;
  return c >> 1;
}

// qb3csztbl: a single value's code at rung r (QB3encode.h:144-150), v below
// 2^(r + 1): the base VLC with the rung 3..7 middle swap; rung 0 is one bit.
template <class C>
__device__ __forceinline__ C single_code(C v, int r, int* len) {
  if (r == 0) {
    *len = 1;
    return v & 1;
  }
  if (r >= 3 && r <= 7) {
    const C a = (C(1) << r) - 1;
    v = v == a ? a + 1 : (v == a + 1 ? a : v);
  }
  const int top = static_cast<int>((v >> r) & 1);
  const int nxt = static_cast<int>((v >> (r - 1)) & 1);
  *len = r + top + (top | nxt);
  if (top) return ((v ^ (C(1) << r)) << 2) | 3;
  if (nxt) return ((v ^ (C(1) << (r - 1))) << 2) | 1;
  return v << 1;
}

// The 16 group-context value codes at rung r >= 1 with the step flip:
// put(i, code, len, value) with len up to 65.
template <int TB, class F>
__device__ __forceinline__ void value_codes(const Val<TB> (&m)[16], int r, F&& put) {
  const uint32_t flip = step_flip<TB>(m, r);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const Val<TB> v = ((flip >> i) & 1) ? m[i] ^ (Val<TB>(1) << r) : m[i];
    int l;
    const Code<TB> cv = vlc<TB>(v, r, &l);
    put(i, cv, l, v);
  }
}

// ienc (QB3encode.h:557-613) at rung r in 4..62: the index encoding's total
// bits, or -1 where the group holds more than 8 distinct values.  put(symbol,
// code, len) gets the prefix (SIGNAL, the codeswitches of max - oldrung and
// r - oldrung, flagless), the 16 index codes (plain codes at rung 2) and
// the live uniques, ordered by descending count, ties in first-seen order.
template <int TB, class F>
__device__ __forceinline__ int index_candidate(const Val<TB> (&m)[16], int r, int oldrung,
                                               F&& put) {
  using V = Val<TB>;
  using C = Code<TB>;
  V u[8];
  int cnt[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    u[k] = 0;
    cnt[k] = 0;
  }
  int nu = 0;
  uint64_t slot = 0;  // each value's unique, 4 bits a value
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    int s = nu;
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (k < nu && u[k] == m[i]) s = k;
    if (s == nu) {
      if (nu == 8) return -1;
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (k == nu) u[k] = m[i];
      ++nu;
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) cnt[k] += k == s;
    slot |= static_cast<uint64_t>(s) << (4 * i);
  }
  uint32_t rank = 0;  // each unique's place in the stable descending sort, 3 bits a unique
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    int rk = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) rk += j < nu && (cnt[j] > cnt[k] || (cnt[j] == cnt[k] && j < k));
    rank |= static_cast<uint32_t>(rk) << (3 * k);
  }
  constexpr int nmask = (1 << ubits_of(TB)) - 1;
  int l1, l2;
  const uint32_t c1 = flagless_cs<TB>(nmask - oldrung, &l1);
  const uint32_t c2 = flagless_cs<TB>(r - oldrung, &l2);
  const int plen = kSigLen<TB> + l1 + l2;
  put(0, static_cast<C>(kSigCode<TB> | (c1 << kSigLen<TB>) | (c2 << (kSigLen<TB> + l1))), plen);
  int total = plen;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const uint32_t fi = (rank >> (3 * static_cast<int>((slot >> (4 * i)) & 15))) & 7;
    int l;
    const uint32_t ic = single_code<uint32_t>(fi, 2, &l);
    put(3 + kStep<TB> * i, static_cast<C>(ic), l);
    total += l;
  }
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    if (p < nu) {
      V v = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (k < nu && ((rank >> (3 * k)) & 7) == static_cast<uint32_t>(p)) v = u[k];
      int l;
      const C uc = single_code<C>(static_cast<C>(v), r, &l);
      put(kUniq<TB> + p, uc, l);
      total += l;
    }
  }
  return total;
}

// cfgenc's header (QB3encode.h:284-361) for a group of common factor cf >= 2
// (cfm = cf - 2) whose divided values reach trung: SIGNAL and the flagless
// rung switch (base), then a '0' (the band's CF again) or a '1' and the
// CF: at trung ('0', the CF's code at trung) or at its own rung (the full
// codeswitch cfrung - trung, the CF less its top bit at cfrung - 1).
template <int TB>
struct CfHead {
  uint32_t base_code, s1_code;
  Code<TB> s2_code;
  int base_len, l1_diff, s1_len, s2_len;

  __device__ __forceinline__ CfHead(Val<TB> cfm, int trung, int oldrung) {
    using C = Code<TB>;
    const int cfrung = topbit(cfm | 1);
    int cst_l;
    const uint32_t cst_c = flagless_cs<TB>(trung - oldrung, &cst_l);
    base_code = kSigCode<TB> | (cst_c << kSigLen<TB>);
    base_len = kSigLen<TB> + cst_l;
    if (trung >= cfrung && (trung < cfrung + ubits_of(TB) || cfrung == 0)) {
      l1_diff = base_len + 2;
      s1_code = 0;
      s1_len = 0;
      s2_code = single_code<C>(static_cast<C>(cfm), trung, &s2_len);
    } else {
      l1_diff = base_len + 1;
      s1_code = codeswitch<TB>(cfrung, trung, &s1_len);
      s2_code = single_code<C>(static_cast<C>(cfm ^ (Val<TB>(1) << cfrung)), cfrung - 1, &s2_len);
    }
  }
};

// The divided group's codes: at trung with the step flip, or one bit a
// value at trung 0.  put(i, code, len).
template <int TB, class F>
__device__ __forceinline__ void body_codes(const Val<TB> (&d)[16], int trung, F&& put) {
  if (trung == 0) {
#pragma unroll
    for (int i = 0; i < 16; ++i) put(i, static_cast<Code<TB>>(d[i] & 1), 1);
  } else {
    value_codes<TB>(d, trung, [&](int i, Code<TB> cv, int l, Val<TB>) { put(i, cv, l); });
  }
}

// One group: its mag-sign values m, bitsused, rung r and the rung of the
// block before (oldrung) in; trial() sizes the candidates and gates the
// index trial (QB3encode.h:700-713), which decides whether the group sets
// its band's CF state; emit() writes the symbols of the candidate chosen
// against the band's incoming CF state.
template <int TB>
struct BestGroup {
  using V = Val<TB>;
  using C = Code<TB>;
  V m[16], bits;
  int r, oldrung;
  V d[16];        // the group divided by its common factor, where that is 2 or more
  V cf, cfm;      // the common factor where active (else 0), biased (cf - 2, else 0)
  int trung;      // the divided group's rung
  bool win_same;  // the index trial wins against the same-CF (or the plain) candidate
  bool win_diff;  // ... against the different-CF (or the plain) candidate

  __device__ __forceinline__ bool active() const { return (bits & ~V(1)) != 0; }
  __device__ __forceinline__ bool has_cf() const { return cf >= 2; }
  __device__ __forceinline__ bool sets_cf() const { return has_cf() && !win_diff; }

  __device__ __forceinline__ void trial() {
    int cs_len;
    codeswitch<TB>(r, oldrung, &cs_len);
    int plain = cs_len;
    cf = 0;
    if (active()) {
      value_codes<TB>(m, r, [&](int, C, int l, V) { plain += l; });
#pragma unroll
      for (int i = 0; i < 16; ++i)
        if (cf != 1) cf = gcd<V>(cf, (m[i] >> 1) + (m[i] & 1));
    }
    int size_same = plain, size_diff = plain;
    trung = 0;
    cfm = 0;
    if (has_cf()) {
      cfm = cf - 2;
      const bool pow2 = (cf & (cf - 1)) == 0;
      const int sh = ctz(cf);
      V dbits = 0;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const V a = (m[i] >> 1) + (m[i] & 1);
        d[i] = wrap<TB>(((pow2 ? a >> sh : a / cf) << 1) - (m[i] & 1));
        dbits |= d[i];
      }
      trung = topbit(dbits | 1);
      int body = 0;
      body_codes<TB>(d, trung, [&](int, C, int l) { body += l; });
      const CfHead<TB> h(cfm, trung, oldrung);
      size_same = h.base_len + 1 + body;
      size_diff = h.l1_diff + h.s1_len + h.s2_len + body;
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i) d[i] = 0;
    }
    const int isize =
        active() && r > 3 && r < 63 ? index_candidate<TB>(m, r, oldrung, [](int, C, int) {}) : -1;
    const int thr = 36 + 3 * ubits_of(TB) + 2 * r;
    win_same = isize >= 0 && size_same >= thr && isize < size_same;
    win_diff = isize >= 0 && size_diff >= thr && isize < size_diff;
  }

  // The symbols for the incoming CF state pin (biased): put(symbol, code,
  // len) for each symbol that is not empty; returns the group's kind.
  template <class F>
  __device__ __forceinline__ int emit(uint64_t pin, F&& put) const {
    int cs_len;
    const uint32_t cs_code = codeswitch<TB>(r, oldrung, &cs_len);
    if (!active()) {  // a flag after the codeswitch, then one bit a value or nothing
      put(0, static_cast<C>(cs_code | (static_cast<uint32_t>(bits & 1) << cs_len)), cs_len + 1);
#pragma unroll
      for (int i = 0; i < 16; ++i)
        put(3 + kStep<TB> * i, static_cast<C>(m[i] & 1), static_cast<int>(bits & 1));
      return bits == 1 ? kBits : kZero;
    }
    const bool same = pin == static_cast<uint64_t>(cfm);
    if (same ? win_same : win_diff) {
      index_candidate<TB>(m, r, oldrung, put);
      return kIdx;
    }
    if (has_cf()) {
      const CfHead<TB> h(cfm, trung, oldrung);
      if (same) {
        put(0, static_cast<C>(h.base_code), h.base_len + 1);
      } else {
        put(0, static_cast<C>(h.base_code | (1u << h.base_len)), h.l1_diff);
        put(1, static_cast<C>(h.s1_code), h.s1_len);
        put(2, h.s2_code, h.s2_len);
      }
      body_codes<TB>(d, trung, [&](int i, C cv, int l) { put(3 + kStep<TB> * i, cv, l); });
      return trung == 0 ? kCf0 : kCf;
    }
    put(0, static_cast<C>(cs_code), cs_len);
    value_codes<TB>(m, r, [&](int i, C cv, int l, V v) {
      if constexpr (TB == 64) {
        const int e = l == 65;  // rung-63 long form: its 65th bit is value bit 62
        put(3 + 2 * i, cv, l - e);
        put(4 + 2 * i, static_cast<C>(e ? (v >> 62) & 1 : 0), e);
      } else {
        put(3 + i, cv, l);
      }
    });
    return kNormal;
  }

  // the rung the "ib" sidecar's meta16 names for a group of kind `kind`
  __device__ __forceinline__ int vrung(int kind) const {
    return kind == kZero || kind == kBits ? 0 : (kind == kCf || kind == kCf0 ? trung : r);
  }

  // the runbits a decoder holds after the group: after a CF0 group it
  // recomputes them from the CF (QB3decode.h:664)
  __device__ __forceinline__ int post_runbits(int kind) const {
    return kind == kCf0 ? topbit((2 * static_cast<uint64_t>(cf) - 1) | 1) : r;
  }
};

}  // namespace qb3
