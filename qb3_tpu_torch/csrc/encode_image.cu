// K8 (fused image-layout VLC + pack) for qb3_tpu_torch, sm_90a.
//
// Plain C entry point, bound with ctypes (qb3_tpu_torch/_build.py).  It
// launches on the given stream and returns cudaGetLastError(); the Python
// wrapper (qb3_tpu_torch/ops/encode_cuda.py) allocates every buffer.

#include <cuda_runtime.h>

#include <cstdint>

#include "bitwriter.cuh"
#include "vlc.cuh"

namespace {

// ---------------------------------------------------------------- K8
//
// Replaces qb3_tpu/ops/encode_pallas.py: encode_pack_image
// (_encode_pack_kernel, _enc_pair), the image-layout encode of u16/u32/u64
// rasters, which the JAX package runs only when QB3_ENC_FUSED asks for it
// and this port runs for every such image whose sides are multiples of 4.
//
// What it computes: phase A (ops/encode_image.py) leaves the mag-sign values
// in an (H, W, C) plane and, per group (raster block x band), its rung, kind
// (0 normal, 1 one bit per value, 2 nothing), prefix code and length, and
// start bit goff (the exclusive prefix sum of the group lengths, taken with
// torch.cumsum by the wrapper, as the JAX package does outside its kernel).
// Each group gathers its 16 values from the plane in curve order, then
// writes its prefix and its 16 value codes at goff.  The stream is the one
// K1 writes over the block-layout phase A.
//
// Bound: memory.  The function reads 16 plane values of tbits / 8 bytes
// and 7 bytes of per-group fields (rung, kind, prefix code and length,
// glen) a group, and writes the stream once; at u16 1024x1024x1 that is
// ~4 MB, ~1.2 us at 3.35 TB/s, against ~10 integer operations a value
// (~0.8 us at the INT32 issue rate).  The port's int64 carriers make this
// kernel read 8 bytes a value and 40 a group instead (~11 MB).  A single
// tile is bound by launch latency, not by either.
//
// Design: one thread per group, through the bit writer K1 uses
// (bitwriter.cuh): an accumulator for the current word, flushed with
// atomicOr, so neighbouring groups share words but never bits.  Each thread
// reads its values where they lie in the plane; a warp's 32 groups span 128
// consecutive pixels of four rows, so L1 serves the strided reads.  The TPU
// kernel's bf16 one-hot MXU relayout, byte planes, W48 slabs, 1024-word
// placement windows and the (W/4 * C) % 128 == 0 shape rule exist for
// Mosaic and are not carried over: any H and W that are multiples of 4 and
// any band count are taken.  Words at or past n_words are dropped.
__global__ void encode_pack_image_kernel(const uint64_t* __restrict__ m,
                                         const int64_t* __restrict__ rung,
                                         const int64_t* __restrict__ gkind,
                                         const int64_t* __restrict__ pcode,
                                         const int64_t* __restrict__ plen,
                                         const int64_t* __restrict__ goff,
                                         int64_t ngroups, int nbx, int C,
                                         uint64_t order, int64_t n_words,
                                         uint32_t* __restrict__ out) {
  const int64_t g = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (g >= ngroups) return;
  const int64_t blk = g / C;
  const int64_t row = 4ll * nbx * C;  // plane elements per image row
  const uint64_t* base = m + (blk / nbx) * 4 * row + (blk % nbx) * 4 * C + g % C;
  qb3::BitWriter bw(out, n_words, goff[g]);
  bw.put(static_cast<uint64_t>(pcode[g]), static_cast<int>(plen[g]));
  const int64_t kind = gkind[g];
  const int r = static_cast<int>(rung[g]);
  if (kind != 2) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int nib = static_cast<int>((order >> (60 - 4 * i)) & 15);  // (dy, dx)
      const uint64_t v = base[(nib >> 2) * row + (nib & 3) * C];
      if (kind == 1) {
        bw.put(v & 1ull, 1);
        continue;
      }
      int len;
      const uint64_t code = qb3::vlc_encode(v, r, &len);
      if (len > 64) {  // rung-63 long form: 64 code bits, then value bit 62
        bw.put(code, 64);
        bw.put((v >> 62) & 1ull, 1);
      } else {
        bw.put(code, len);
      }
    }
  }
  bw.flush();
}

}  // namespace

extern "C" int qb3_encode_pack_image(const void* m, const void* rung,
                                     const void* gkind, const void* pcode,
                                     const void* plen, const void* goff,
                                     int64_t ngroups, int nbx, int C,
                                     uint64_t order, int64_t n_words, void* out,
                                     void* stream) {
  if (ngroups > 0) {
    const int threads = 256;
    const int64_t blocks = (ngroups + threads - 1) / threads;
    encode_pack_image_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint64_t*>(m), static_cast<const int64_t*>(rung),
        static_cast<const int64_t*>(gkind), static_cast<const int64_t*>(pcode),
        static_cast<const int64_t*>(plen), static_cast<const int64_t*>(goff),
        ngroups, nbx, C, order, n_words, static_cast<uint32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
