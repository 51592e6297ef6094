// K8 (fused image-layout VLC + pack) for qb3_tpu_torch, sm_90a.
//
// Plain C entry point, bound with ctypes (qb3_tpu_torch/_build.py).  It
// launches on the given stream after one memset and returns
// cudaGetLastError(); the Python wrapper (qb3_tpu_torch/ops/encode_cuda.py)
// allocates every buffer.

#include <cuda_runtime.h>

#include <cstdint>

#include "blockpack.cuh"
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
// length glen.  Each group gathers its 16 values from the plane in curve
// order and writes its prefix and its 16 value codes at its start bit, the
// exclusive prefix sum of glen, which the kernel scans itself
// (blockpack.cuh; the JAX package takes it with a cumsum outside its
// kernel), so a call is one memset and one launch.  The stream is the one
// K1 writes over the block-layout phase A.  glen is trusted, as the JAX
// kernel trusts its offsets; a glen outside [0, kMaxBits] is clamped into
// it, so no input overflows the block's window.
//
// Bound: memory.  The function reads 16 plane values of tbits / 8 bytes
// and 7 bytes of per-group fields (rung, kind, prefix code and length,
// glen) a group, and writes the stream once; at u16 1024x1024x1 that is
// ~4 MB, ~1.2 us at 3.35 TB/s, against ~10 integer operations a value
// (~0.8 us at the INT32 issue rate).  The port's int64 carriers make this
// kernel read 8 bytes a value and 40 a group instead (~11 MB).
//
// Design: kParts threads a group (blockpack.cuh), each coding 16 / kParts
// of its values.  A block takes bpc consecutive raster blocks of one block-row
// (bpc * C groups, at most kGroups; one raster block of C groups where C >
// kGroups), so what it reads of the plane is four row segments of
// 4 * bpc * C values: four bulk copies stage them, and five more the
// block's per-group fields, each contiguous.  A thread then reads its
// values from shared memory in curve order (through a table of the 16
// (dy, dx) offsets), codes them, finds its offset in the group from the
// code lengths of the group's earlier parts and writes them into the
// block's window at the group's start, which comes from glen.  The TPU
// kernel's bf16 one-hot MXU relayout, byte planes, W48 slabs, 1024-word
// placement windows and the (W/4 * C) % 128 == 0 shape rule exist for
// Mosaic and are not carried over: any H and W that are multiples of 4 and
// any band count up to 256 are taken.  Measured on an H100 80GB HBM3 at
// 700 W (ab_pack.py, device time from the profiler): a call (the memset
// and the kernel) takes 0.0128-0.0130 ms at u16 1024x1024x1 and 0.0164-
// 0.0168 at u64, against 0.0187-0.0189 and 0.0276-0.0280 for the design it
// replaces with its wrapper's scan, zero fill and narrowing (one thread a
// group reading the plane from device memory, a global atomicOr a word).
// The kernel alone is still slower there at u16 (0.0113 against 0.0099):
// a block codes no value before its rows have all landed.
constexpr int kGroups = 128;            // groups a block packs where C <= kGroups
constexpr int kMaxBands = 256;          // one raster block a block where C > kGroups
constexpr int kMaxBits = 64 + 16 * 65;  // a group's bits at most: prefix, 16 codes

__host__ __device__ constexpr uint32_t k8_smem(int bpc, int C) {
  return 4 * qb3::region_bytes(4 * bpc * C * 8) + 5 * qb3::region_bytes(bpc * C * 8)
         + ((bpc * C * kMaxBits + 31) / 32 + 2) * 4;
}

template <typename T>
__device__ __forceinline__ int clamp_int(T v, int hi) {
  return v < 0 ? 0 : (v > hi ? hi : static_cast<int>(v));
}

__global__ void __launch_bounds__(kMaxBands * qb3::kParts, 2)
    encode_pack_image_kernel(const uint64_t* __restrict__ m, const int64_t* __restrict__ rung,
                             const int64_t* __restrict__ gkind, const int64_t* __restrict__ pcode,
                             const int64_t* __restrict__ plen, const int64_t* __restrict__ glen_in,
                             int nbx, int C, int bpc, int cpr, uint64_t order, int64_t n_words,
                             uint32_t* __restrict__ out, int64_t* __restrict__ total,
                             int32_t* __restrict__ glen, int* ticket, uint64_t* state) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int64_t s_vb, s_start;
  __shared__ int s_val[16];  // value i of the curve: its row segment + dx * C, in values
  __shared__ __align__(8) uint64_t bar;
  const int tid = threadIdx.x;
  const int64_t row = 4ll * nbx * C;  // plane values per image row
  const uint32_t rreg = qb3::region_bytes(4 * bpc * C * 8), freg = qb3::region_bytes(bpc * C * 8);
  unsigned char* rf = smem + 4 * rreg;
  uint32_t* win = reinterpret_cast<uint32_t*>(rf + 5 * freg);
  if (tid == 0) s_vb = atomicAdd(ticket, 1);  // block index in start order
  __syncthreads();
  // the block's raster blocks bx0 .. of block-row by: groups g0 .. g0 + ng - 1
  const int64_t vb = s_vb;
  const int64_t by = vb / cpr;
  const int bx0 = static_cast<int>(vb - by * cpr) * bpc;
  const int ng = (nbx - bx0 < bpc ? nbx - bx0 : bpc) * C;
  const int64_t g0 = (by * nbx + bx0) * C;
  const uint64_t* top = m + 4 * by * row + 4ll * bx0 * C;
  const auto bytes = [](const void* p) { return static_cast<const unsigned char*>(p); };
  const uint32_t rb = static_cast<uint32_t>(4 * ng * 8), fb = static_cast<uint32_t>(ng * 8);
  const qb3::Span sp[9] = {  // the four row segments, then the five fields
      {bytes(top), smem, rb, 8},
      {bytes(top + row), smem + rreg, rb, 8},
      {bytes(top + 2 * row), smem + 2 * rreg, rb, 8},
      {bytes(top + 3 * row), smem + 3 * rreg, rb, 8},
      {bytes(rung + g0), rf, fb, 8},
      {bytes(gkind + g0), rf + freg, fb, 8},
      {bytes(pcode + g0), rf + 2 * freg, fb, 8},
      {bytes(plen + g0), rf + 3 * freg, fb, 8},
      {bytes(glen_in + g0), rf + 4 * freg, fb, 8}};
  if (tid < 16) {
    const int nib = static_cast<int>((order >> (60 - 4 * tid)) & 15);  // (dy, dx)
    const uintptr_t src = reinterpret_cast<uintptr_t>(top + (nib >> 2) * row);
    s_val[tid] = static_cast<int>(((nib >> 2) * rreg + (src & 15)) / 8) + (nib & 3) * C;
  }
  qb3::stage(sp, qb3::smem_addr(&bar));
  const uint64_t* vals = reinterpret_cast<const uint64_t*>(smem);  // the four row segments

  // thread tid = kParts * group + part codes values [kVals * part, kVals *
  // part + kVals) of its group (part 0 also its prefix) at its offset in
  // the group; the group starts where glen puts it
  constexpr int kVals = 16 / qb3::kParts;
  const int g = tid / qb3::kParts, q = tid % qb3::kParts;
  const bool live = g < ng;
  const auto field = [&](int k) {  // rung, kind, prefix code, prefix length, glen
    return *reinterpret_cast<const int64_t*>(sp[4 + k].dst() + 8 * g);
  };
  const int gl = live && q == 0 ? clamp_int(field(4), kMaxBits) : 0;
  int L;
  const int excl = qb3::block_scan(gl, &L);
  const int gstart = __shfl_sync(0xffffffffu, excl, (tid & 31) & ~(qb3::kParts - 1));
  if (tid == 0) qb3::store_relaxed64(state + vb, (vb == 0 ? qb3::kPrefix : qb3::kAgg) | L);
  if (live && q == 0) glen[g0 + g] = gl;

  const int64_t kind = live ? field(1) : 2;
  const int r = clamp_int(live ? field(0) : 0, 63);
  const int blk = g / C;
  const int at = blk * 4 * C + (g - blk * C);  // the group's block and band in a row
  uint64_t code[kVals];
  int clen[kVals];
  uint32_t extra = 0;  // value bit 62 of each rung-63 long code (its 65th bit)
  int len = q == 0 && live ? clamp_int(field(3), 64) : 0;  // the prefix
#pragma unroll
  for (int i = 0; i < kVals; ++i) {
    const uint64_t v = kind != 2 ? vals[s_val[q * kVals + i] + at] : 0;
    if (kind == 2) {
      code[i] = 0;
      clen[i] = 0;
    } else if (kind == 1) {
      code[i] = v & 1ull;
      clen[i] = 1;
    } else {
      code[i] = qb3::vlc_encode(v, r, &clen[i]);
      extra |= static_cast<uint32_t>((v >> 62) & 1ull) << i;
    }
    len += clen[i];
  }
  const int off = qb3::part_offset(len);
  qb3::clear_window(win, L);
  __syncthreads();

  if (live) {
    qb3::SmemWriter w(win, gstart + off);
    if (q == 0) {
      const int n = clamp_int(field(3), 64);
      w.put(qb3::low_bits(static_cast<uint64_t>(field(2)), n), n);
    }
#pragma unroll
    for (int i = 0; i < kVals; ++i) {
      if (clen[i] > 64) {  // rung-63 long form: 64 code bits, then value bit 62
        w.put(code[i], 64);
        w.put((extra >> i) & 1u, 1);
      } else {
        w.put(code[i], clen[i]);
      }
    }
    w.flush();
  }
  if (tid < 32) {  // after the placement, so the earlier blocks had time to publish
    const int64_t start = qb3::lookback(state, vb, 0);
    if (tid == 0) {
      if (vb != 0) qb3::store_relaxed64(state + vb, qb3::kPrefix | (start + L));
      if (vb == gridDim.x - 1) *total = start + L;
      s_start = start;
    }
  }
  __syncthreads();
  qb3::store_window(win, L, s_start, out, n_words);
}

}  // namespace

// K8.  m (H, W, C) u64 mag-sign plane; rung, gkind, pcode, plen, glen_in
// (nby * nbx * C,) int64 in raster-block x band order (nby = H / 4, nbx =
// W / 4); out (n_words,) u32, total (1,) int64, glen (ngroups,) int32;
// scratch: the ticket (8 bytes) and nblocks state words (8 bytes each).
// out, total and scratch lie in one span of zero_bytes from out, which the
// memset zeroes.  nblocks = nby * ceil(nbx / bpc), bpc = max(1, 128 / C).
extern "C" int qb3_encode_pack_image(const void* m, const void* rung, const void* gkind,
                                     const void* pcode, const void* plen, const void* glen_in,
                                     int64_t nby, int nbx, int C, uint64_t order,
                                     int64_t n_words, void* out, void* total, void* glen,
                                     void* scratch, int64_t zero_bytes, int64_t nblocks,
                                     void* stream) {
  if (C < 1 || C > kMaxBands || nbx < 0 || nby < 0 || n_words < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int bpc = C >= kGroups ? 1 : kGroups / C;
  const int cpr = (nbx + bpc - 1) / bpc;
  if (nblocks != nby * cpr || nblocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const auto cs = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, static_cast<size_t>(zero_bytes), cs);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nblocks > 0) {
    const uint32_t smem = k8_smem(bpc, C);
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(encode_pack_image_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    auto* tk = static_cast<int*>(scratch);
    const int threads = (bpc * C * qb3::kParts + 31) / 32 * 32;
    encode_pack_image_kernel<<<static_cast<unsigned>(nblocks), threads, smem, cs>>>(
        static_cast<const uint64_t*>(m), static_cast<const int64_t*>(rung),
        static_cast<const int64_t*>(gkind), static_cast<const int64_t*>(pcode),
        static_cast<const int64_t*>(plen), static_cast<const int64_t*>(glen_in), nbx, C, bpc,
        cpr, order, n_words, static_cast<uint32_t*>(out), static_cast<int64_t*>(total),
        static_cast<int32_t*>(glen), tk, reinterpret_cast<uint64_t*>(tk + 2));
  }
  return static_cast<int>(cudaGetLastError());
}
