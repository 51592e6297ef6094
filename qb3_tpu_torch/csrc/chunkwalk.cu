// K2, the "ic" chunk walk for qb3_tpu_torch, sm_90a.
//
// Replaces qb3_tpu/ops/chunkwalk_pallas.py: chunkwalk8 (_chunkwalk8_kernel).
//
// What it computes: the "ic" sidecar anchors the stream every K blocks with
// a bit offset and the per-band entry rungs.  One chunk's K * NB groups
// decode back to back: codeswitch (dsw), the rung-0 BITS/ZERO flag, 16
// values as the group-context VLC at the band's running rung, and for BASE
// modes the step-bit restore (QB3decode.h:603-723, :285-289).  Output:
// (nchunks, K, NB, 16) u32 mag-sign values, for u8 (ubits 3) and u16
// (ubits 4) streams.
//
// Semantics: those of the JAX package's portable walk
// (qb3_tpu/ops/decode_chunked.py: decode_chunked), bit for bit, including
// on corrupt streams: each group reads NREG words from its clipped base
// word and a 64-bit window at a clamped word index of that register set.
//
// Bound: latency.  Each chunk is a serial walk of K * NB groups, 16 values
// each, so a thread does a few thousand dependent integer operations and
// moves only ~1 KB.  The single 512x512x3 image has 2048 chunks, far fewer
// threads than the card holds; a batch of 128 tiles fills it.
//
// Design: one thread per chunk; 128 chunks form a tile whose stream
// window K3 staged (out[t] = words from row wrow[t]); a thread reads word i
// at i - wrow[t] * 128 of its tile's window, and from the stream itself
// when a corrupt chunk walks outside the window.  The accumulator is a
// native uint64_t, not the TPU's two u32 lanes, and words are read
// directly, not by the TPU's masked OR over all MAXW words.  The per-band
// rungs live in a local array.

#include <cuda_runtime.h>

#include <cstdint>

#include "vlc.cuh"

namespace {

constexpr int kTile = 128;   // chunks per window tile
constexpr int kMaxBands = 256;

template <int UBITS>
__global__ void chunkwalk_kernel(const uint32_t* __restrict__ words, int64_t n32,
                                 const uint32_t* __restrict__ win,
                                 const int32_t* __restrict__ wrow, int R,
                                 const int32_t* __restrict__ starts,
                                 const int32_t* __restrict__ entry,
                                 int64_t nchunks, int K, int NB, int apply_step,
                                 uint32_t* __restrict__ out) {
  constexpr int NREG = UBITS == 3 ? 7 : 11;  // decode_chunked._NREG
  constexpr int PER = UBITS == 3 ? 6 : 3;    // values per 64-bit window
  constexpr int NMASK = (1 << UBITS) - 1;
  const int64_t c = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (c >= nchunks) return;
  const int64_t t = c / kTile;
  const int64_t wbase = static_cast<int64_t>(wrow[t]) * 128;
  const uint32_t* twin = win + t * static_cast<int64_t>(R);

  uint8_t rungs[kMaxBands];
  for (int b = 0; b < NB; ++b) rungs[b] = static_cast<uint8_t>(entry[c * NB + b] & NMASK);

  int32_t off = starts[c];
  uint32_t regs[NREG + 2];
  regs[NREG] = regs[NREG + 1] = 0;
  uint4* dst = reinterpret_cast<uint4*>(out + c * static_cast<int64_t>(K) * NB * 16);

  for (int g = 0; g < K * NB; ++g) {
    const int b = g % NB;
    int64_t base = off >> 5;
    base = base < 0 ? 0 : (base > n32 - NREG ? n32 - NREG : base);
    const int32_t phase = off - static_cast<int32_t>(base << 5);
#pragma unroll
    for (int i = 0; i < NREG; ++i) {
      const int64_t r = base + i - wbase;
      regs[i] = (r >= 0 && r < R) ? twin[r] : words[base + i];
    }
    // 64 bits at register-set offset o; word indices outside [0, NREG-1]
    // read as NREG-1, like the JAX select chain's default
    auto window = [&](int32_t o) -> uint64_t {
      int wi = o >> 5;
      if (wi < 0 || wi > NREG - 1) wi = NREG - 1;
      const int sh = o & 31;
      const uint64_t lo = regs[wi] | (static_cast<uint64_t>(regs[wi + 1]) << 32);
      return (lo >> sh) | (sh ? static_cast<uint64_t>(regs[wi + 2]) << (64 - sh) : 0ull);
    };

    const uint64_t w0 = window(phase);
    int cs_len = 1, delta = 0;
    if (w0 & 1ull) delta = qb3::dsw(w0 >> 1, UBITS, &cs_len);
    const int rung = (rungs[b] + delta) & NMASK;
    rungs[b] = static_cast<uint8_t>(rung);
    const bool is_group = rung != 0;
    const bool is_bits = !is_group && ((w0 >> cs_len) & 1ull);
    int32_t o = phase + cs_len + (is_group ? 0 : 1);

    uint32_t vals[16];
#pragma unroll
    for (int v0 = 0; v0 < 16; v0 += PER) {
      const uint64_t w = window(o);
      int shift = 0;
#pragma unroll
      for (int i = v0; i < (v0 + PER < 16 ? v0 + PER : 16); ++i) {
        const uint32_t ww = static_cast<uint32_t>(w >> shift);
        int gl;
        const uint32_t gv = qb3::vlc_group32(ww, rung, &gl);
        vals[i] = is_group ? gv : (is_bits ? (ww & 1u) : 0u);
        shift += is_group ? gl : (is_bits ? 1 : 0);
      }
      o += shift;
    }

    if (apply_step && is_group) qb3::step_restore(vals, rung);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      dst[g * 4 + q] = make_uint4(vals[4 * q], vals[4 * q + 1], vals[4 * q + 2], vals[4 * q + 3]);
    off += o - phase;
  }
}

}  // namespace

extern "C" int qb3_chunkwalk(const void* words, int64_t n32, const void* win,
                             const void* wrow, int R, const void* starts,
                             const void* entry, int64_t nchunks, int K, int NB,
                             int apply_step, int ubits, void* out, void* stream) {
  if ((ubits != 3 && ubits != 4) || NB < 1 || NB > kMaxBands || K < 1 ||
      n32 < (ubits == 3 ? 7 : 11))
    return static_cast<int>(cudaErrorInvalidValue);
  if (nchunks > 0) {
    const int threads = 64;
    const unsigned blocks = static_cast<unsigned>((nchunks + threads - 1) / threads);
    auto kern = ubits == 3 ? chunkwalk_kernel<3> : chunkwalk_kernel<4>;
    kern<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(words), n32, static_cast<const uint32_t*>(win),
        static_cast<const int32_t*>(wrow), R, static_cast<const int32_t*>(starts),
        static_cast<const int32_t*>(entry), nchunks, K, NB, apply_step,
        static_cast<uint32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
