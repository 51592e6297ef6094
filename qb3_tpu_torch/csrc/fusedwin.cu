// K4 (wavefront_fused) for qb3_tpu_torch, sm_90a.
//
// Replaces qb3_tpu/ops/fusedwin_pallas.py: wavefront_fused (_fused_kernel,
// with _window_build, _seg_prefix and _dsw_arith32).
//
// What it computes: the "ix" sidecar decode.  The sidecar gives every group
// its bit length, so the wrapper hands the kernel each group's start bit
// goff (an exclusive prefix sum per tile).  Per group the kernel reads its
// register window, parses the codeswitch (QB3decode.h:603-618), runs the
// band rung chain (a prefix sum of the codeswitch deltas per band, modulo
// 2^ubits, restarting at every tile of a flat batch), and walks the 16
// values (group-context VLC at the rung; u64 with the rung-63 65-bit form),
// with the BASE-mode step restore when asked.  Output: (ngroups, 16) u64
// mag-sign values and the (ngroups,) rungs.  With nbands == 0 the caller
// gives off / rung / kind instead and the kernel only walks.
//
// Semantics: those of decode_indexed_narrow(use_pallas=False), the JAX
// package's XLA walk, bit for bit, damaged streams included.  A group reads
// NREG words from word goff >> 5, with JAX's gather rules (a negative index
// counts from the end, indices clamp into the stream), window words past
// NREG - 1 through the XLA select chains (a 64-bit window at word index
// wi >= NREG - 1 starts at word NREG - 1; the u8 accumulator reads zero
// there).  The TPU kernel's 8-word-aligned window reads zero past its end,
// so on a sidecar whose lengths exceed the format's maximum it can differ.
//
// Bound: latency.  A group is ~16 dependent VLC decodes; it moves its
// window (~20-150 bytes, shared with its neighbours) and 128 output bytes.
//
// Design: one thread per group, 128 groups per block.  The block stages its
// stream span, R words from its first group's base word, in shared memory
// with 16-byte loads; a word outside the span (a damaged stream) is read
// from the stream, so R moves speed, never values.  The TPU's planar view,
// bf16 byte planes and one-hot MXU window build are a gather and are gone.
// The rung chain: a Hillis-Steele scan with stride nbands * 2^k inside the
// block (segments end at tile starts), and across blocks a decoupled
// look-back: blocks take their index from an atomic ticket in start order,
// publish their per-band sums (aggregate, then inclusive prefix) as one
// 32-bit word each, and read their predecessors' words back to the nearest
// prefix.  A block only waits on blocks that started before it, so the
// chain always makes progress; the walk itself starts after the carry.

#include <cuda_runtime.h>

#include <cstdint>

#include "vlc.cuh"

namespace {

constexpr int kThreads = 128;  // groups per block (ops/fusedwin_cuda.FUSED_G)
constexpr int kMaxBands = 256;
constexpr int kMaxR = 8192;    // staged words: 32 KB of shared memory (FUSED_MAX_R)
constexpr uint32_t kAgg = 1u << 8, kPrefix = 2u << 8;

__device__ __forceinline__ uint32_t load_relaxed(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_relaxed(uint32_t* p, uint32_t v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// The stream as JAX's gather reads it, through the block's staged span.
struct Stream {
  const uint32_t* words;
  int64_t n32;
  const uint32_t* win;
  int64_t wbase;
  int R;
  __device__ uint32_t word(int64_t i) const {
    if (i < 0) i += n32;
    i = i < 0 ? 0 : (i >= n32 ? n32 - 1 : i);
    const int64_t r = i - wbase;
    return (r >= 0 && r < R) ? win[r] : __ldg(words + i);
  }
};

// A group's register window: words base .. base + nreg - 1 of the stream.
struct Window {
  Stream s;
  int64_t base;
  int nreg;
  // window word j; zero outside [0, nreg - 1] (the u8 accumulator's reads)
  __device__ uint32_t reg(int j) const { return (j >= 0 && j < nreg) ? s.word(base + j) : 0u; }
  // 64 window bits from bit o; word indices outside [0, nreg - 2] read from
  // word nreg - 1 on, as the XLA select chain's default
  __device__ uint64_t bits64(int o) const {
    int wi = o >> 5;
    const int sh = o & 31;
    if (wi < 0 || wi > nreg - 1) wi = nreg - 1;
    uint64_t w = (static_cast<uint64_t>(reg(wi)) | static_cast<uint64_t>(reg(wi + 1)) << 32) >> sh;
    if (sh) w |= static_cast<uint64_t>(reg(wi + 2)) << (64 - sh);
    return w;
  }
};

// The 16-value walk of one group from value bit `off` of its window.
template <int TBITS>
__device__ __forceinline__ void walk(const Window& W, int off, int rung, int kind,
                                     uint64_t (&vals)[16]) {
  const bool isg = kind == 1, isb = kind == 2;
  if (TBITS == 8) {
    // u64 accumulator refilled a word at a time: a 3-value step uses <= 27
    // bits, less than the 32-bit refill
    const int sh = off & 31;
    int k = off >> 5;
    uint64_t acc = (static_cast<uint64_t>(W.reg(k)) | static_cast<uint64_t>(W.reg(k + 1)) << 32) >> sh;
    int navail = 64 - sh;
    k += 2;
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
      acc >>= shift;
      navail -= shift;
      if (navail < 27) {
        acc |= static_cast<uint64_t>(W.reg(k)) << navail;
        navail += 32;
        ++k;
      }
    }
  } else if (TBITS == 16) {
    // one 64-bit window per 3 values (codes of <= 17 bits)
#pragma unroll
    for (int v0 = 0; v0 < 16; v0 += 3) {
      const uint64_t w = W.bits64(off);
      int shift = 0;
#pragma unroll
      for (int i = v0; i < (v0 + 3 < 16 ? v0 + 3 : 16); ++i) {
        const uint32_t ww = static_cast<uint32_t>(w >> shift);
        int gl;
        const uint32_t gv = qb3::vlc_group32(ww, rung, &gl);
        vals[i] = isg ? gv : (isb ? (ww & 1u) : 0u);
        shift += isg ? gl : (isb ? 1 : 0);
      }
      off += shift;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const uint64_t w = W.bits64(off);
      int gl;
      uint64_t gv = qb3::vlc64(w, rung, &gl);
      // rung-63 long form: the stream bit past the 64-bit window is value bit 62
      if (TBITS == 64 && gl == 65) gv |= (W.bits64(off + 64) & 1ull) << 62;
      vals[i] = isg ? gv : (isb ? (w & 1ull) : 0ull);
      off += isg ? gl : (isb ? 1 : 0);
    }
  }
}

template <int TBITS, bool PARSE>
__global__ void __launch_bounds__(kThreads)
fused_kernel(const uint32_t* __restrict__ words, int64_t n32, const int32_t* __restrict__ goff,
             int64_t ngroups, int nreg, int R, int nbands, int64_t per_tile, int apply_step,
             const int32_t* __restrict__ off_in, const int32_t* __restrict__ rung_in,
             const int32_t* __restrict__ kind_in, uint64_t* __restrict__ out,
             int32_t* __restrict__ rung_out, uint32_t* state, int* ticket) {
  constexpr int UBITS = TBITS == 8 ? 3 : TBITS == 16 ? 4 : TBITS == 32 ? 5 : 6;
  extern __shared__ uint4 s_win4[];
  __shared__ int64_t s_blk;
  __shared__ int s_x[kThreads];
  __shared__ int s_carry[kMaxBands];
  const int tid = threadIdx.x;
  int64_t blk = blockIdx.x;
  if (PARSE) {
    // block index in start order: the look-back waits only on running blocks
    if (tid == 0) s_blk = atomicAdd(ticket, 1);
    __syncthreads();
    blk = s_blk;
  }
  const int64_t g0 = blk * kThreads;
  const int64_t g = g0 + tid;
  const bool live = g < ngroups;

  // stage the block's span: R words from its first group's base word
  const int64_t wbase = static_cast<int64_t>(goff[g0] >> 5) & ~static_cast<int64_t>(3);
  for (int q = tid; q < R / 4; q += kThreads) {
    const int64_t i = wbase + 4 * q;
    uint4 v;
    if (i >= 0 && i + 4 <= n32) {
      v = __ldg(reinterpret_cast<const uint4*>(words + i));
    } else {
      uint32_t t[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) t[e] = (i + e >= 0 && i + e < n32) ? words[i + e] : 0u;
      v = make_uint4(t[0], t[1], t[2], t[3]);
    }
    s_win4[q] = v;
  }
  __syncthreads();
  const int32_t gofs = goff[live ? g : g0];
  const Window W{Stream{words, n32, reinterpret_cast<const uint32_t*>(s_win4), wbase, R},
                 static_cast<int64_t>(gofs >> 5), nreg};

  int off, rung, kind;
  if (PARSE) {
    // codeswitch parse
    const int off0 = gofs & 31;
    const uint64_t w0 = W.bits64(off0);
    int cs_len = 1, delta = 0;
    if (w0 & 1ull) delta = qb3::dsw(w0 >> 1, UBITS, &cs_len);

    // in-block band prefix sums; a segment ends where a tile starts
    const int64_t tstart = (g / per_tile) * per_tile;
    s_x[tid] = live ? delta : 0;
    __syncthreads();
    for (int d = nbands; d < kThreads; d <<= 1) {
      const int add = (tid >= d && g - d >= tstart) ? s_x[tid - d] : 0;
      __syncthreads();
      s_x[tid] += add;
      __syncthreads();
    }

    // the block's last segment [lo, last] and each band's sum over it
    const int64_t last = (g0 + kThreads < ngroups ? g0 + kThreads : ngroups) - 1;
    const int64_t tlast = (last / per_tile) * per_tile;
    const bool closed = tlast >= g0;  // the segment starts here: its sums are prefixes
    const int64_t lo = closed ? tlast : g0;
    auto local = [&](int b) {
      const int64_t il = last - ((last % nbands) - b + nbands) % nbands;
      return il >= lo ? s_x[il - g0] : 0;
    };
    uint32_t* mine = state + blk * nbands;
    for (int b = tid; b < nbands; b += kThreads)
      store_relaxed(mine + b, (closed ? kPrefix : kAgg) | (local(b) & 63));
    const bool needs_carry = g0 % per_tile != 0;
    for (int b = tid; b < nbands; b += kThreads) {
      int carry = 0;
      if (needs_carry) {
        for (int64_t j = blk - 1;; --j) {
          uint32_t s;
          do {
            s = load_relaxed(state + j * nbands + b);
          } while (!(s & (kAgg | kPrefix)));
          carry += s & 63;
          if (s & kPrefix) break;
        }
        if (!closed) store_relaxed(mine + b, kPrefix | ((carry + local(b)) & 63));
      }
      s_carry[b] = carry;
    }
    __syncthreads();

    const bool first_seg = g < (g0 / per_tile + 1) * per_tile;
    rung = (s_x[tid] + (first_seg ? s_carry[g % nbands] : 0)) & ((1 << UBITS) - 1);
    const bool rung0 = rung == 0;
    kind = rung0 ? (((w0 >> cs_len) & 1ull) ? 2 : 0) : 1;
    off = off0 + cs_len + (rung0 ? 1 : 0);
    if (live) rung_out[g] = rung;
  } else {
    off = live ? off_in[g] : 0;
    rung = live ? rung_in[g] : 0;
    kind = live ? kind_in[g] : 0;
  }
  if (!live) return;

  uint64_t vals[16];
  walk<TBITS>(W, off, rung, kind, vals);
  if (apply_step && kind == 1 && rung >= 1) qb3::step_restore(vals, rung);
  ulonglong2* dst = reinterpret_cast<ulonglong2*>(out + g * 16);
#pragma unroll
  for (int q = 0; q < 8; ++q) dst[q] = make_ulonglong2(vals[2 * q], vals[2 * q + 1]);
}

template <bool PARSE>
void launch(int tbits, unsigned blocks, size_t smem, cudaStream_t stream, const uint32_t* words,
            int64_t n32, const int32_t* goff, int64_t ngroups, int nreg, int R, int nbands,
            int64_t per_tile, int apply_step, const int32_t* off, const int32_t* rung,
            const int32_t* kind, uint64_t* out, int32_t* rung_out, uint32_t* state, int* ticket) {
  auto kern = tbits == 8    ? fused_kernel<8, PARSE>
              : tbits == 16 ? fused_kernel<16, PARSE>
              : tbits == 32 ? fused_kernel<32, PARSE>
                            : fused_kernel<64, PARSE>;
  kern<<<blocks, kThreads, smem, stream>>>(words, n32, goff, ngroups, nreg, R, nbands, per_tile,
                                           apply_step, off, rung, kind, out, rung_out, state,
                                           ticket);
}

}  // namespace

// K4.  words (n32,) u32, 16-byte aligned; goff (ngroups,) int32 group start
// bits; R staged words per block (a multiple of 4); nbands > 0: parse in the
// kernel, per_tile groups per independent stream, rung_out (ngroups,) int32,
// scratch (1 + ceil(ngroups / 128) * nbands,) int32 zeroed; nbands == 0:
// off / rung / kind (ngroups,) int32 from the caller.  out (ngroups, 16) u64.
extern "C" int qb3_wavefront_fused(const void* words, int64_t n32, const void* goff,
                                   int64_t ngroups, int nreg, int R, int tbits, int nbands,
                                   int64_t per_tile, int apply_step, const void* off,
                                   const void* rung, const void* kind, void* out,
                                   void* rung_out, void* scratch, void* stream) {
  if (n32 < 1 || nreg < 1 || R < 4 || R % 4 || R > kMaxR || nbands < 0 ||
      nbands > kMaxBands || (tbits != 8 && tbits != 16 && tbits != 32 && tbits != 64) ||
      (nbands > 0 && (per_tile < 1 || per_tile % nbands || ngroups % per_tile)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (ngroups > 0) {
    const unsigned blocks = static_cast<unsigned>((ngroups + kThreads - 1) / kThreads);
    const size_t smem = static_cast<size_t>(R) * 4;
    auto* ticket = static_cast<int*>(scratch);
    auto* state = reinterpret_cast<uint32_t*>(ticket + 1);
    const auto* w = static_cast<const uint32_t*>(words);
    const auto* go = static_cast<const int32_t*>(goff);
    auto* o = static_cast<uint64_t*>(out);
    const auto cs = static_cast<cudaStream_t>(stream);
    if (nbands > 0)
      launch<true>(tbits, blocks, smem, cs, w, n32, go, ngroups, nreg, R, nbands, per_tile,
                   apply_step, nullptr, nullptr, nullptr, o, static_cast<int32_t*>(rung_out),
                   state, ticket);
    else
      launch<false>(tbits, blocks, smem, cs, w, n32, go, ngroups, nreg, R, 0, 1, apply_step,
                    static_cast<const int32_t*>(off), static_cast<const int32_t*>(rung),
                    static_cast<const int32_t*>(kind), o, nullptr, nullptr, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}
