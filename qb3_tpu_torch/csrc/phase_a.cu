// K9 (the fast encoder's phase A in one pass) for qb3_tpu_torch, sm_90a.
//
// Plain C entry point, bound with ctypes (qb3_tpu_torch/_build.py).  It
// launches one kernel on the given stream and returns cudaGetLastError();
// the Python wrapper (qb3_tpu_torch/ops/phase_a_cuda.py) allocates every
// buffer.

#include <cuda_runtime.h>

#include <cstdint>

#include "phase_a.cuh"

namespace {

using namespace qb3;

// ---------------------------------------------------------------- K9
//
// Replaces no TPU kernel: qb3_tpu's fast phase A (qb3_tpu/ops/encode.py,
// encode_fast_blocks) is XLA ops, which XLA fuses on the TPU.  Its PyTorch
// form (qb3_tpu_torch/ops/encode.py, the twin) is ~200 int64 elementwise
// ops and concatenations a call, each a full pass over the groups' 17
// symbols; at 128 u8 512x512x3 tiles they took 0.287 ms of device a tile.
//
// What it computes: everything encode_fast_blocks returns, for tiles of any
// H, W >= 4 (the last block-row and block-column shifted up / left to fit,
// QB3encode.h:409-416), 1-256 bands, u8-u64, either curve, with or without
// the step (BASE / FTL).  Per group (raster block x band): the 16 values in
// curve order, less the core band's (cband), the running delta against the
// band's previous value in scan order (the last value of the block before,
// or entry_prev), mag-sign; bitsused, the rung and the codeswitch from the
// block before's rung (or entry_runbits); then the K1 symbols in stream
// order, [prefix, v0 .. v15] or, at u64, [prefix, v0, e0, .., v15, e15]
// with e the 65th bit of a rung-63 long code: codes int64, lengths int32.
// It also writes each group's rung and each tile's exit state.
//
// Bound: memory.  A group reads 16 int64 carrier values (128 bytes) and
// writes 17 (33) symbols of 12 bytes and its rung: 340 bytes a u8 group,
// 2.1 GB at 128 u8 512x512x3 tiles, 0.64 ms at 3.35 TB/s, against ~25
// integer operations a value.
//
// Design: one thread a group.  A block takes a run of nbk consecutive
// raster blocks of one block-row (nbk * C groups, at most kGroups; one
// raster block where C > kGroups), so what it reads of the tile is four
// row segments of 4 * nbk * C values: the block stages them in shared
// memory at the values' width (32 bits up to u32), coalesced.  The only
// state that crosses blocks is the last value and the rung of the block
// before the run (its halo): the threads of the run's first block
// recompute them from device memory (16 values and the last of the block
// before that), which costs less than a second pass.  Within the run a
// group takes its predecessor's last value and rung from shared memory.
// Values, masks and codes are 32-bit up to u16 and 64-bit only at u64
// (codes at u32 need 34 bits); the rung is a count of leading zeros.  The
// 17 (33) symbols of each group are staged in shared memory (codes at
// their width, lengths as bytes) so that the stores of the run's codes
// and lengths, each one contiguous span, are coalesced.  Measured on an
// H100 80GB HBM3 at 700 W (ab_phase_a.py, device time from the profiler):
// 0.8249 ms at 128 u8 512x512x3 tiles (77% of the bound), 0.0084 ms at
// one, 0.0146 ms at u64 1024x1024x1, against 36.22, 0.395 and 0.662 ms
// for the PyTorch ops it replaces.
constexpr int kGroups = 256;  // groups a block takes where C <= kGroups
constexpr int kMaxBands = 256;

template <int TB>
__host__ __device__ constexpr int nsym() { return TB == 64 ? 33 : 17; }

// Byte offsets of the shared regions of a CTA of at most ng groups: its
// four row segments (at most 4 * ng values each), the groups' codes, last
// values and rungs, the 16 lane offsets and the groups' lengths.
template <int TB>
struct Smem {
  uint32_t code, last, rung, off, len, bytes;
  __host__ __device__ constexpr explicit Smem(int ng)
      : code(round16(16 * ng * sizeof(Val<TB>))),
        last(code + round16(ng * nsym<TB>() * sizeof(Code<TB>))),
        rung(last + round16(ng * sizeof(Val<TB>))),
        off(rung + 4 * ng),
        len(off + 16 * 4),
        bytes(len + round16(ng * nsym<TB>())) {}
};

template <int TB>
__global__ void __launch_bounds__(kGroups)
    phase_a_kernel(const int64_t* __restrict__ img, const int64_t* __restrict__ entry_prev,
                   const void* __restrict__ entry_run, int run64,
                   const int64_t* __restrict__ cband, Geometry geo, int skipstep,
                   int64_t* __restrict__ codes, int32_t* __restrict__ lens,
                   int64_t* __restrict__ rung_out, int64_t* __restrict__ exit_prev,
                   int64_t* __restrict__ exit_run) {
  using V = Val<TB>;
  using CodeT = Code<TB>;
  constexpr int S = nsym<TB>();
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = geo.C;
  const int64_t cta = blockIdx.x;
  const int64_t per_tile = static_cast<int64_t>(geo.nby) * geo.chunks;
  const int64_t t = cta / per_tile;
  const int by = static_cast<int>((cta - t * per_tile) / geo.chunks);
  const int bx0 = static_cast<int>(cta - t * per_tile - static_cast<int64_t>(by) * geo.chunks) *
                  geo.nbk;
  const int nbr = geo.nbx - bx0 < geo.nbk ? geo.nbx - bx0 : geo.nbk;  // blocks of this run
  const int ng = nbr * C;
  const int64_t xlo = geo.ox(bx0);
  const int span = static_cast<int>((geo.ox(bx0 + nbr - 1) + 4 - xlo) * C);
  const Smem<TB> lay(geo.nbk * C);
  V* s_in = reinterpret_cast<V*>(smem);
  auto* s_code = reinterpret_cast<CodeT*>(smem + lay.code);
  V* s_last = reinterpret_cast<V*>(smem + lay.last);
  int* s_rung = reinterpret_cast<int*>(smem + lay.rung);
  int* s_off = reinterpret_cast<int*>(smem + lay.off);
  unsigned char* s_len = smem + lay.len;

  const int tid = threadIdx.x, nthr = blockDim.x;
  // the four row segments of the run, at the values' width
  stage_rows<TB>(img, geo, t, by, xlo, span, s_in);
  if (tid < 16) {
    const int nib = geo.lane(tid);
    s_off[tid] = (nib >> 2) * span + (nib & 3) * C;
  }

  const bool live = tid < ng;
  const int blk = live ? tid / C : 0;
  const int c = live ? tid - blk * C : 0;
  const int cb = live ? static_cast<int>(cband[c]) : 0;
  const int64_t tb0 = (static_cast<int64_t>(by) * geo.nbx + bx0 - 1);  // the halo block
  // the halo: the last value and the rung of the block before the run
  V hlast = 0;
  int hrung = 0;
  if (live && blk == 0) {
    const int64_t ts = t * C + c;
    const int64_t prev_state = entry_prev[ts];
    const int prev_run = run64 ? static_cast<int>(static_cast<const int64_t*>(entry_run)[ts])
                               : static_cast<const int32_t*>(entry_run)[ts];
    halo_state<TB>(img, geo, t, tb0, c, cb, prev_state, prev_run, &hlast, &hrung);
  }
  __syncthreads();

  // the group's values, less the core band's
  V m[16];
  const int at = static_cast<int>((geo.ox(bx0 + blk) - xlo) * C);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int o = s_off[i] + at;
    const V v = s_in[o + c];
    m[i] = cb == c ? wrap<TB>(v) : wrap<TB>(v - s_in[o + cb]);
  }
  if (live) s_last[tid] = m[15];
  __syncthreads();
  const V last = m[15];
  V p = blk == 0 ? hlast : s_last[tid - C];
  V bits = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const V v = m[i];
    m[i] = mags<TB>(wrap<TB>(v - p));
    p = v;
    bits |= m[i];
  }
  const int r = topbit(bits | 1);
  if (live) s_rung[tid] = r;
  __syncthreads();
  const int oldrung = blk == 0 ? hrung : s_rung[tid - C];

  if (live) {
    const int64_t gt = (static_cast<int64_t>(by) * geo.nbx + bx0) * C + tid;  // group in tile
    const int64_t ngroups = static_cast<int64_t>(geo.nby) * geo.nbx * C;
    if (rung_out != nullptr) rung_out[t * ngroups + gt] = r;
    if (by == geo.nby - 1 && bx0 + blk == geo.nbx - 1) {
      exit_prev[t * C + c] = static_cast<int64_t>(last);
      exit_run[t * C + c] = r;
    }
    CodeT* code = s_code + tid * S;
    unsigned char* len = s_len + tid * S;
    int pl;
    uint32_t pc = codeswitch<TB>(r, oldrung, &pl);
    if (r == 0) {  // all-zero or single-bit group: a flag after the codeswitch
      pc |= static_cast<uint32_t>(bits & 1) << pl;
      pl += 1;
    }
    code[0] = pc;
    len[0] = static_cast<unsigned char>(pl);
    if (r == 0) {
      const int l1 = static_cast<int>(bits & 1);  // one bit a value, or nothing
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        if constexpr (TB == 64) {
          code[1 + 2 * i] = m[i] & 1;
          len[1 + 2 * i] = static_cast<unsigned char>(l1);
          code[2 + 2 * i] = 0;
          len[2 + 2 * i] = 0;
        } else {
          code[1 + i] = m[i] & 1;
          len[1 + i] = static_cast<unsigned char>(l1);
        }
      }
    } else {
      const uint32_t flip = skipstep ? 0u : step_flip<TB>(m, r);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        if ((flip >> i) & 1) m[i] ^= V(1) << r;
        int l;
        const CodeT cv = vlc<TB>(m[i], r, &l);
        if constexpr (TB == 64) {
          const int e = l == 65;  // rung-63 long form: its 65th bit is value bit 62
          code[1 + 2 * i] = cv;
          len[1 + 2 * i] = static_cast<unsigned char>(l - e);
          code[2 + 2 * i] = e ? (m[i] >> 62) & 1 : 0;
          len[2 + 2 * i] = static_cast<unsigned char>(e);
        } else {
          code[1 + i] = cv;
          len[1 + i] = static_cast<unsigned char>(l);
        }
      }
    }
  }
  __syncthreads();

  // the run's codes and lengths: one contiguous span each
  const int64_t base = (t * geo.nby * geo.nbx + static_cast<int64_t>(by) * geo.nbx + bx0) * C * S;
  const int n = ng * S;
  for (int j = tid; j < n; j += nthr) {
    codes[base + j] = static_cast<int64_t>(s_code[j]);
    lens[base + j] = s_len[j];
  }
}

template <int TB>
cudaError_t launch(const int64_t* img, const int64_t* entry_prev, const void* entry_run,
                   int run64, const int64_t* cband, int64_t ntiles, const Geometry& geo,
                   int skipstep, int64_t* codes, int32_t* lens, int64_t* rung,
                   int64_t* exit_prev, int64_t* exit_run, cudaStream_t cs) {
  const int ng = geo.nbk * geo.C;
  const uint32_t smem = Smem<TB>(ng).bytes;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        phase_a_kernel<TB>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int64_t nctas = ntiles * geo.nby * geo.chunks;
  const int threads = (ng + 31) / 32 * 32;
  phase_a_kernel<TB><<<static_cast<unsigned>(nctas), threads, smem, cs>>>(
      img, entry_prev, entry_run, run64, cband, geo, skipstep, codes, lens, rung, exit_prev,
      exit_run);
  return cudaGetLastError();
}

}  // namespace

// K9.  img (ntiles, H, W, C) int64 carrier of tbits-wide values, H and W at
// least 4; entry_prev (ntiles, C) int64; entry_run (ntiles, C) int64
// (run64 1) or int32 (run64 0); cband (C,) int64, each in [0, C); order the
// scan curve; skipstep 1 for FTL.  Writes codes (ntiles, ngroups, S) int64
// and lens int32 (S = 17, 33 at u64; ngroups = ceil(H / 4) * ceil(W / 4) *
// C in raster-block x band order), rung (ntiles, ngroups) int64 unless
// null, exit_prev and exit_run (ntiles, C) int64.
extern "C" int qb3_phase_a_fast(const void* img, const void* entry_prev, const void* entry_run,
                                int run64, const void* cband, int64_t ntiles, int H, int W,
                                int C, int tbits, uint64_t order, int skipstep, void* codes,
                                void* lens, void* rung, void* exit_prev, void* exit_run,
                                void* stream) {
  if (C < 1 || C > kMaxBands || H < 4 || W < 4 || ntiles < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Geometry geo = make_geometry(H, W, C, order, kGroups);
  if (ntiles * geo.nby * geo.chunks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  if (ntiles == 0) return static_cast<int>(cudaGetLastError());
  const auto run = [&](auto launcher) {
    return launcher(static_cast<const int64_t*>(img), static_cast<const int64_t*>(entry_prev),
                     entry_run, run64, static_cast<const int64_t*>(cband), ntiles, geo,
                     skipstep, static_cast<int64_t*>(codes), static_cast<int32_t*>(lens),
                     static_cast<int64_t*>(rung), static_cast<int64_t*>(exit_prev),
                     static_cast<int64_t*>(exit_run), static_cast<cudaStream_t>(stream));
  };
  cudaError_t err;
  switch (tbits) {
    case 8:
      err = run(launch<8>);
      break;
    case 16:
      err = run(launch<16>);
      break;
    case 32:
      err = run(launch<32>);
      break;
    case 64:
      err = run(launch<64>);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
