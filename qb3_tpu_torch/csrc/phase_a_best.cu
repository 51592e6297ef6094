// K10 (the best modes' phase A in one pass) for qb3_tpu_torch, sm_90a.
//
// Plain C entry point, bound with ctypes (qb3_tpu_torch/_build.py).  It
// zeroes the look-back's ticket and state with one cudaMemsetAsync, launches
// one kernel on the given stream and returns cudaGetLastError(); the Python
// wrapper (qb3_tpu_torch/ops/phase_a_cuda.py) allocates every buffer.

#include <cuda_runtime.h>

#include <cstdint>

#include "best_group.cuh"
#include "blockpack.cuh"
#include "phase_a.cuh"

namespace {

using namespace qb3;

// ---------------------------------------------------------------- K10
//
// Replaces no TPU kernel: qb3_tpu's best phase A (qb3_tpu/ops/encode_best.py,
// encode_best_blocks) is XLA ops, which XLA fuses on the TPU.  Its PyTorch
// form (qb3_tpu_torch/ops/encode_best.py, the twin) is ~1125 int64 ops a
// call: the index trial's (..., 16, 16) compare, a cumsum, a stable sort
// and scatters, the CF candidate's GCD tree and division, a cummax for the
// CF chain, each a full pass over the groups' 27 (43) symbols; at a pass
// of 8 Landsat tiles (u16 512x512x8) they took ~5.75 ms of device a tile.
//
// What it computes: everything encode_best_blocks returns, for tiles of any
// H, W >= 4, 1-256 bands, u8-u64, either curve.  Per group (raster block x
// band), in registers: the 16 values less the core band's, the deltas in
// scan order, mag-sign, bitsused, the rung and the codeswitch (as K9); the
// plain candidate (the BASE codes with the step flip); the CF candidate (a
// binary GCD of the 16 magnitudes, exact on the u64 magnitude 2^63, the
// exact division, trung, the same-CF and different-CF headers and sizes);
// the index candidate (at most 8 uniques in first-seen order, their counts,
// ranks by descending count with ties in first-seen order, the index and
// unique codes); the index trial's gating (QB3encode.h:700-713) and whether
// the group sets the band's CF state.  Then, after the CF chain, the chosen
// symbols in stream order [S0, S1, S2, v0 .. v15, u0 .. u7] or, at u64, with
// each value's 65th bit after it, and the "ib" / "ic" metadata.
//
// The CF chain: a block's incoming CF is that of the last block before it,
// in its band, that sets the state.  Whether a group sets it does not
// depend on the incoming CF, so the chain is a "last set wins" scan per
// band: within a CTA a Hillis-Steele max-scan of the set blocks' indices in
// shared memory, across CTAs blockpack.cuh's decoupled look-back over the
// tile's earlier runs (CTAs take tickets in start order, publish their own
// last set run at once, and wait only on earlier tickets).  A state word
// holds the index + 1 of the last run at or before it with a set block (0:
// none, then entry_cf), combined by max; that run's last set CF lies in
// `agg`, written before the state word that names it.
//
// Bound: memory.  A group reads 16 int64 carrier values (128 bytes) and
// writes 27 (43) symbols of 12 bytes and 28 bytes of metadata: 480 bytes a
// u16 group, 62.9 MB a Landsat tile, 0.0188 ms at 3.35 TB/s; the integer
// work (~2000 operations a group) is of the same order.
//
// Design: one thread a group, as K9: a CTA takes a run of nbk consecutive
// raster blocks of one block-row (nbk * C groups, at most kGroups; one
// raster block where C > kGroups), stages their four row segments in
// shared memory at the values' width, coalesced, and recomputes the halo
// (the last value and rung of the block before the run) from device
// memory.  Values, masks and codes are 32-bit up to u16 and 64-bit only at
// u32 (codes) and u64.  The symbols of each group are staged in shared
// memory (over the row segments, which are read by then) so that the
// stores of the run's codes and lengths, each one contiguous span, are
// coalesced.
constexpr int kGroups = 256;  // groups a CTA takes where C <= kGroups
constexpr int kMaxBands = 256;

template <int TB>
struct Smem {  // byte offsets of the shared regions of a CTA of at most ng groups
  uint32_t len, last, rung, idx, cfm, off, excl, bytes;
  __host__ __device__ constexpr Smem(int ng, int C)
      : len(round16(16 * ng * sizeof(Val<TB>)) > round16(ng * best_nsym<TB>() * sizeof(Code<TB>))
                ? round16(16 * ng * sizeof(Val<TB>))
                : round16(ng * best_nsym<TB>() * sizeof(Code<TB>))),
        last(len + round16(ng * best_nsym<TB>())),
        rung(last + round16(ng * sizeof(Val<TB>))),
        idx(rung + round16(4 * ng)),
        cfm(idx + round16(4 * ng)),
        off(cfm + 8 * ng),
        excl(off + 16 * 4),
        bytes(excl + 8 * C) {}
};

struct Max {
  __device__ static uint64_t combine(uint64_t a, uint64_t b) { return a > b ? a : b; }
};

struct Out {  // the kernel's outputs, one pointer each
  int64_t* codes;
  int32_t* lens;
  int32_t* meta16;
  int64_t *cfv, *post_run, *pcf_in, *exit_prev, *exit_run, *exit_cf;
};

template <int TB>
__global__ void __launch_bounds__(kGroups)
    phase_a_best_kernel(const int64_t* __restrict__ img, const int64_t* __restrict__ entry_prev,
                        const void* __restrict__ entry_run, int run64,
                        const int64_t* __restrict__ entry_cf, const int64_t* __restrict__ cband,
                        Geometry geo, Out out, uint64_t* __restrict__ state,
                        int64_t* __restrict__ agg, unsigned long long* __restrict__ ticket) {
  using V = Val<TB>;
  using CodeT = Code<TB>;
  constexpr int S = best_nsym<TB>();
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int64_t s_ticket;
  const int C = geo.C;
  const int tid = threadIdx.x, nthr = blockDim.x;
  if (tid == 0) s_ticket = static_cast<int64_t>(atomicAdd(ticket, 1ull));
  __syncthreads();
  const int64_t cta = s_ticket;  // runs in start order: the look-back waits on earlier ones only
  const int64_t runs = static_cast<int64_t>(geo.nby) * geo.chunks;  // a tile
  const int64_t t = cta / runs;
  const int64_t run = cta - t * runs;
  const int by = static_cast<int>(run / geo.chunks);
  const int bx0 = static_cast<int>(run - static_cast<int64_t>(by) * geo.chunks) * geo.nbk;
  const int nbr = geo.nbx - bx0 < geo.nbk ? geo.nbx - bx0 : geo.nbk;  // blocks of this run
  const int ng = nbr * C;
  const int64_t xlo = geo.ox(bx0);
  const int span = static_cast<int>((geo.ox(bx0 + nbr - 1) + 4 - xlo) * C);
  const Smem<TB> lay(geo.nbk * C, C);
  V* s_in = reinterpret_cast<V*>(smem);
  auto* s_code = reinterpret_cast<CodeT*>(smem);  // over s_in, once that is read
  unsigned char* s_len = smem + lay.len;
  V* s_last = reinterpret_cast<V*>(smem + lay.last);
  int* s_rung = reinterpret_cast<int*>(smem + lay.rung);
  int* s_idx = reinterpret_cast<int*>(smem + lay.idx);
  uint64_t* s_cfm = reinterpret_cast<uint64_t*>(smem + lay.cfm);
  int* s_off = reinterpret_cast<int*>(smem + lay.off);
  uint64_t* s_excl = reinterpret_cast<uint64_t*>(smem + lay.excl);

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
  V hlast = 0;
  int hrung = 0;
  if (live && blk == 0) {
    const int64_t ts = t * C + c;
    const int prev_run = run64 ? static_cast<int>(static_cast<const int64_t*>(entry_run)[ts])
                               : static_cast<const int32_t*>(entry_run)[ts];
    halo_state<TB>(img, geo, t, tb0, c, cb, entry_prev[ts], prev_run, &hlast, &hrung);
  }
  __syncthreads();

  // the group's values, less the core band's, then deltas and mag-sign
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

  // ---- the candidates' sizes and whether the group sets its band's CF
  BestGroup<TB> g;
#pragma unroll
  for (int i = 0; i < 16; ++i) g.m[i] = m[i];
  g.bits = bits;
  g.r = r;
  g.oldrung = oldrung;
  g.trial();
  const bool is_set = live && g.sets_cf();

  // ---- the CF chain within the run: the last set block at or before each
  int mine = is_set ? blk : -1;
  if (live) {
    s_idx[tid] = mine;
    s_cfm[tid] = static_cast<uint64_t>(g.cfm);
  }
  __syncthreads();
  for (int k = 1; k < nbr; k <<= 1) {
    const int v = live && blk >= k ? s_idx[tid - k * C] : -1;
    __syncthreads();
    mine = v > mine ? v : mine;
    if (live) s_idx[tid] = mine;
    __syncthreads();
  }

  // ---- and across runs: each band's CF state before the run
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;
  const int64_t first = t * runs;
  for (int band = warp; band < C; band += nwarps) {
    const int li = s_idx[(nbr - 1) * C + band];  // the run's last set block
    uint64_t* st = state + band;
    if (li >= 0 && lane == 0) {
      agg[cta * C + band] = static_cast<int64_t>(s_cfm[li * C + band]);
      __threadfence();
      store_relaxed64(st + cta * C, kPrefix | static_cast<uint64_t>(run + 1));
    } else if (lane == 0) {
      store_relaxed64(st + cta * C, kAgg);
    }
    const uint64_t excl = lookback<Max>(st, cta, first, C);
    if (lane == 0) {
      __threadfence();
      if (li < 0) store_relaxed64(st + cta * C, kPrefix | excl);
      s_excl[band] = excl ? load_relaxed64(reinterpret_cast<const uint64_t*>(agg) +
                                           (first + static_cast<int64_t>(excl) - 1) * C + band)
                          : static_cast<uint64_t>(entry_cf[t * C + band]);
    }
  }
  __syncthreads();

  // ---- the choice, the symbols and the metadata
  if (live) {
    const int pi = blk > 0 ? s_idx[tid - C] : -1;
    const uint64_t pin = pi >= 0 ? s_cfm[pi * C + c] : s_excl[c];  // the incoming CF state
    CodeT* code = s_code + tid * S;
    unsigned char* len = s_len + tid * S;
#pragma unroll
    for (int k = 0; k < S; ++k) {
      code[k] = 0;
      len[k] = 0;
    }
    const int kind = g.emit(pin, [&](int k, CodeT cv, int l) {
      code[k] = cv;
      len[k] = static_cast<unsigned char>(l);
    });
    const bool cf_grp = kind == kCf || kind == kCf0;
    const int64_t gt = (static_cast<int64_t>(by) * geo.nbx + bx0) * C + tid;  // group in tile
    const int64_t gi = t * static_cast<int64_t>(geo.nby) * geo.nbx * C + gt;
    out.meta16[gi] = kind | (g.vrung(kind) << 3) | ((len[0] + len[1] + len[2]) << 9);
    out.cfv[gi] = cf_grp ? static_cast<int64_t>(g.cfm) : 0;
    out.post_run[gi] = g.post_runbits(kind);
    out.pcf_in[gi] = static_cast<int64_t>(pin);
    if (by == geo.nby - 1 && bx0 + blk == geo.nbx - 1) {
      out.exit_prev[t * C + c] = static_cast<int64_t>(last);
      out.exit_run[t * C + c] = r;
      out.exit_cf[t * C + c] = static_cast<int64_t>(is_set ? static_cast<uint64_t>(g.cfm) : pin);
    }
  }
  __syncthreads();

  // the run's codes and lengths: one contiguous span each
  const int64_t base = (t * geo.nby * geo.nbx + static_cast<int64_t>(by) * geo.nbx + bx0) * C * S;
  const int n = ng * S;
  for (int j = tid; j < n; j += nthr) {
    out.codes[base + j] = static_cast<int64_t>(s_code[j]);
    out.lens[base + j] = s_len[j];
  }
}

template <int TB>
cudaError_t launch(const int64_t* img, const int64_t* entry_prev, const void* entry_run,
                   int run64, const int64_t* entry_cf, const int64_t* cband, int64_t ntiles,
                   const Geometry& geo, const Out& out, uint64_t* state, int64_t* agg,
                   unsigned long long* ticket, cudaStream_t cs) {
  const int ng = geo.nbk * geo.C;
  const uint32_t smem = Smem<TB>(ng, geo.C).bytes;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        phase_a_best_kernel<TB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int64_t nctas = ntiles * geo.nby * geo.chunks;
  const int threads = (ng + 31) / 32 * 32;
  phase_a_best_kernel<TB><<<static_cast<unsigned>(nctas), threads, smem, cs>>>(
      img, entry_prev, entry_run, run64, entry_cf, cband, geo, out, state, agg, ticket);
  return cudaGetLastError();
}

}  // namespace

// K10.  img (ntiles, H, W, C) int64 carrier of tbits-wide values, H and W at
// least 4; entry_prev and entry_cf (ntiles, C) int64; entry_run (ntiles, C)
// int64 (run64 1) or int32 (run64 0); cband (C,) int64, each in [0, C);
// order the scan curve.  Writes codes (ntiles, ngroups, S) int64 and lens
// int32 (S = 27, 43 at u64; ngroups = ceil(H / 4) * ceil(W / 4) * C in
// raster-block x band order), meta16 (ntiles, ngroups) int32, cfv,
// post_run and pcf_in (ntiles, ngroups) int64, exit_prev, exit_run and
// exit_cf (ntiles, C) int64.  scratch: scratch_words int64 words, at least
// 1 + 2 * ntiles * runs * C (runs = the CTAs a tile: ceil(H / 4) times the
// runs a block-row); the first 1 + ntiles * runs * C are zeroed here.
extern "C" int qb3_phase_a_best(const void* img, const void* entry_prev, const void* entry_run,
                                int run64, const void* entry_cf, const void* cband,
                                int64_t ntiles, int H, int W, int C, int tbits, uint64_t order,
                                void* codes, void* lens, void* meta16, void* cfv, void* post_run,
                                void* pcf_in, void* exit_prev, void* exit_run, void* exit_cf,
                                void* scratch, int64_t scratch_words, void* stream) {
  if (C < 1 || C > kMaxBands || H < 4 || W < 4 || ntiles < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Geometry geo = make_geometry(H, W, C, order, kGroups);
  const int64_t nstate = ntiles * geo.nby * geo.chunks * C;
  if (ntiles * geo.nby * geo.chunks > 0x7fffffff || scratch_words < 1 + 2 * nstate)
    return static_cast<int>(cudaErrorInvalidValue);
  if (ntiles == 0) return static_cast<int>(cudaGetLastError());
  const auto cs = static_cast<cudaStream_t>(stream);
  auto* words = static_cast<uint64_t*>(scratch);
  cudaError_t err = cudaMemsetAsync(words, 0, (1 + nstate) * sizeof(uint64_t), cs);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Out out{static_cast<int64_t*>(codes),    static_cast<int32_t*>(lens),
                static_cast<int32_t*>(meta16),   static_cast<int64_t*>(cfv),
                static_cast<int64_t*>(post_run), static_cast<int64_t*>(pcf_in),
                static_cast<int64_t*>(exit_prev), static_cast<int64_t*>(exit_run),
                static_cast<int64_t*>(exit_cf)};
  const auto run = [&](auto launcher) {
    return launcher(static_cast<const int64_t*>(img), static_cast<const int64_t*>(entry_prev),
                    entry_run, run64, static_cast<const int64_t*>(entry_cf),
                    static_cast<const int64_t*>(cband), ntiles, geo, out, words + 1,
                    reinterpret_cast<int64_t*>(words + 1 + nstate),
                    reinterpret_cast<unsigned long long*>(words), cs);
  };
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
