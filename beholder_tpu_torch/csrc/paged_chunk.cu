// Paged-KV chunk attention for Hopper (sm_90a), bound through a plain C
// interface (ctypes) by beholder_tpu_torch/ops/paged_attention.py.
//
// Replaces the TPU kernel beholder_tpu/ops/paged_attention.py::_chunk_kernel
// (launched by _chunk_call, public as paged_chunk_attention). Each slot's
// W-token query chunk, at positions lens[s]..lens[s]+W-1, attends the slot's
// committed positions (< lens[s]) read in place from the (N, Hkv, Dh, page)
// pools through the page table, plus the chunk's own k/v (an overlay that is
// never written to the pool), causally per row and under an optional window.
// Prefix-hit admission (one slot, a suffix over cached pages), fused-wave
// admission (lens 0: the chunk attends itself only) and speculative
// decoding's fused verify (every slot, max_draft + 1 rows) run through it.
//
// What bounds it: at the serving shapes, neither bytes nor operations. A
// fused wave (8 x 256 tokens, Dh 64) moves ~5.2 MB of q/out/chunk k/v, about
// 1.6 us at 3.35 TB/s, against ~0.54 GFLOP of causal products (~0.55 us at
// the bf16 tensor-core rate); a warm prefix admit moves ~0.36 MB (~0.11 us).
// Both sit far below a kernel launch, so the floor in practice is latency:
// how fast one block walks its tiles. At the long-context shape (8 pages of
// 512 tokens a slot) each block walks ~58 key tiles, so the time a tile
// takes, its load latency and its two products, is the kernel's time. The
// TPU kernel's VMEM assembly, DMA rounds and slots_per_block grid are not
// carried over.
//
// What the design does about that:
// - One block per (slot, kv head, R tiles of 64 query rows), where the rows
//   are the G x W (group head, chunk row) pairs of that kv head, contiguous
//   in q and out. 4 R warps, each 16 rows. R (row_tiles, 1 or 2) is a
//   template parameter, picked at launch by the wrapper's autotune table
//   (ops/autotune.py): a block of two row tiles loads each key tile once
//   for both. It is neutral by construction: a row's terms, their order
//   and its key tiles do not depend on the block it sits in (the next
//   point), so every R gives the same bits. A template keeps R = 1 the
//   launch it was (launch bound 128, no runtime block size in the tile
//   loop: chosen at run time, R cost that launch up to 7 %, PERF.md) at
//   twice the instantiations. R = 4 is left out: 512 threads at the 255
//   registers a thread that the int8 and fp8 kernels at Dh 128 take cannot
//   launch (65,536 registers an SM), and a launch bound of 512 would cap
//   them at 128 registers and spill.
// - 64-key tiles at absolute positions: tile i holds positions [64 i,
//   64 i + 64), those below lens[s] read in place from the pages, those at
//   or above it from the chunk's own k/v (the one tile that straddles
//   lens[s] takes both), from the tile holding lo to the one holding the
//   block's last visible position; tiles before every row's window or after
//   every row are skipped whole. So a key meets a query at the same tile
//   and lane whatever lens[s] is, and a row at position p sums the same
//   terms in the same order whichever chunk row it sits in: speculative
//   decoding's exactness (spec on == spec off) holds through this kernel.
//   A tile masked for a row leaves its max, sum and output unchanged.
// - Both products on the tensor cores (flash_mma.cuh): mma.sync bf16 with
//   f32 sums, k and v tiles in bf16 shared memory laid out [key][d] with
//   padded rows, the score accumulator 16 x 64 a warp in registers, p
//   handed to PV in registers. The q fragments are read from the resident
//   q tile by ldmatrix at each tile (registers go to the prefetch below).
// - Context tiles come d-major from the pools and need dequantizing, so
//   they pass through registers: each warp takes 16 keys of the tile (8
//   when a block holds two row tiles, 8 warps), a
//   lane loads 8 consecutive keys at one head dim (16 bytes of bf16, 8 of
//   int8/fp8) when the run lies in one page and below lens[s], key by key
//   otherwise, dequantizes them with the keys' scales (one lane a key,
//   passed by shuffle) and writes them into the [key][d] tile. The next
//   tile's loads start before the current tile's products, so their
//   latency hides behind the mma work.
// - Overlay rows are row-major (W, Dh) and arrive by cp.async. k and v
//   tiles are double-buffered: one barrier a tile.
// - A page column at or past live_pages reads as zeros (the reference's
//   assembly), and a position at or past lens[s] is never read from a page.
//   Any page size; runs of 8 keys take the vector load when page % 8 == 0
//   and the pools are aligned for it.
// - A test-only control (plant >= 0; every launch of the port passes -1):
//   the block of slot 0 and kv head 0 that holds row `plant` walks key
//   tiles that start 32 positions earlier, so its rows sum the same terms
//   in other groups. It is not neutral, and the bitwise check of the row
//   tile candidates must see it (chip_smoke.py).
// Head dims 1 to 128: one instantiation each per pool family and row-tile
// count at the widths 8, 16, 32, 64 and 128 (the wrapper picks the width:
// the next one up), in two libraries built from this file. This one
// (PAGED_CHUNK_PADDED 0) takes head dims equal to their width, every stride
// a compile-time constant. paged_chunk_padded.cu (PAGED_CHUNK_PADDED 1)
// takes a head dim dh below its width at run time. The pools keep their
// (N, Hkv, dh, page) layout and nothing is padded in memory: the kernel
// reads pages, q and the chunk at dh, zero-fills its shared tiles past it
// (and Dh 8 to the mma's K of 16), and stores only columns below dh. Rows
// of q, the chunk and out whose dh is not a multiple of 8 are not 16-byte
// aligned: they load value by value instead of by cp.async, and store by
// bf16 pairs (even dh) or values (odd dh). The pages' runs lie along the
// token axis, so their vector loads do not depend on dh. The padded build
// is a library of its own so that the run-time dh costs the exact widths
// nothing and the two builds run side by side.
// Next steps: a split of the context across blocks and a two-pass softmax
// (ROADMAP B.2.b).
//
// The arithmetic follows the dense op sequence of the reference
// (_chunk_block_math) for every pool family, since the chunk path's context
// is bf16 after dequant: each score a bf16 x bf16 product summed in f32,
// rounded to bf16, then divided by sqrt(Dh) in f32; masked to -1e30 (row j
// sees positions <= lens[s]+j, and with a window only those > lens[s]+j-window);
// an online softmax in f32 (p zeroed where the score is <= -5e29), p rounded
// to bf16 before PV, PV accumulated in f32, out = acc / max(l, 1e-37) in bf16.
// The reference normalises the weights before rounding them and sums the
// softmax in one pass; the online recurrence here differs from it by
// rounding, not by algorithm.

#include <cuda_fp16.h>
#include <cuda_fp8.h>

#include "flash_mma.cuh"

#ifndef PAGED_CHUNK_PADDED
#define PAGED_CHUNK_PADDED 0
#endif

namespace {

// whether this build takes a head dim below its width (module notes)
constexpr bool kPadded = PAGED_CHUNK_PADDED;

using namespace flash;

enum Mode { kBf16 = 0, kInt8 = 1, kFp8 = 2 };

template <int MODE> struct Elem { using T = __nv_bfloat16; };
template <> struct Elem<kInt8> { using T = int8_t; };
template <> struct Elem<kFp8> { using T = __nv_fp8_storage_t; };

template <int MODE>
__device__ __forceinline__ float load_scale(const void* scales, size_t idx) {
  if (MODE == kInt8) return static_cast<const float*>(scales)[idx];
  if (MODE == kFp8) {
    // E8M0: 2**(e - 127) built from the f32 exponent field, never exp2
    return __int_as_float(
        static_cast<int>(static_cast<const uint8_t*>(scales)[idx]) << 23);
  }
  return 1.0f;
}

// one pool element to bf16: bf16 as is; int8 and fp8 to f32, times the
// decoded scale, rounded to bf16 (the reference's assembly)
template <int MODE>
__device__ __forceinline__ __nv_bfloat16 dequant(typename Elem<MODE>::T e, float s) {
  if constexpr (MODE == kBf16) {
    return e;
  } else if constexpr (MODE == kInt8) {
    return __float2bfloat16_rn(static_cast<float>(e) * s);
  } else {
    const __half_raw h = __nv_cvt_fp8_to_halfraw(e, __NV_E4M3);
    return __float2bfloat16_rn(__half2float(__half(h)) * s);
  }
}

// A run of 8 consecutive pool elements (one head dim, 8 keys) in registers:
// 4 words of bf16 or 2 of int8/fp8. Element j of a run, element j set into
// a zeroed run, and a run loaded whole (j a compile-time index after
// unrolling).
template <int MODE>
constexpr int kRunWords = MODE == kBf16 ? 4 : 2;

template <int MODE>
__device__ __forceinline__ typename Elem<MODE>::T run_elem(const uint32_t* r, int j) {
  if constexpr (MODE == kBf16) {
    return __ushort_as_bfloat16(static_cast<unsigned short>(r[j >> 1] >> (16 * (j & 1))));
  } else {
    return static_cast<typename Elem<MODE>::T>(static_cast<uint8_t>(r[j >> 2] >> (8 * (j & 3))));
  }
}

template <int MODE>
__device__ __forceinline__ void run_set(uint32_t* r, int j, typename Elem<MODE>::T e) {
  if constexpr (MODE == kBf16) {
    r[j >> 1] |= static_cast<uint32_t>(__bfloat16_as_ushort(e)) << (16 * (j & 1));
  } else {
    r[j >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(e)) << (8 * (j & 3));
  }
}

template <int MODE>
__device__ __forceinline__ void load_run(uint32_t* r, const typename Elem<MODE>::T* p) {
  if constexpr (MODE == kBf16) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    r[0] = u.x;
    r[1] = u.y;
    r[2] = u.z;
    r[3] = u.w;
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    r[0] = u.x;
    r[1] = u.y;
  }
}

// runs of 8 keys a lane holds per context tile, for k and for v: two
// 8-key groups (the warp's 16 keys) at ceil(D / 32) head dims (lane, lane +
// 32, ...)
template <int D>
constexpr int kRuns = 2 * ((D + 31) / 32);

// row tiles a block can hold (blockDim.x = kThreads x row tiles)
constexpr int kMaxRowTiles = 2;

// row_tiles query tiles, then two stages of a k tile and a v tile
template <int D>
constexpr size_t smem_bytes(int row_tiles) {
  return sizeof(__nv_bfloat16) * (row_tiles + 4) * Dims<D>::kElems;
}
static_assert(smem_bytes<128>(kMaxRowTiles) <= 227 * 1024,
              "shared memory over the per-block limit");

// Whether a context tile is whole (every row a context key) or straddles
// lens[s]: a compile-time flag, so whole tiles carry no row test.
template <bool B>
struct Whole {
  static constexpr bool kValue = B;
};

// Rows [row_from, kTile) of a tile whose row r is chunk row r0 + r of the
// (T, D) chunk, by cp.async (rows below row_from hold context keys and are
// left alone; chunk rows at or past T and head dims at or past D read as
// zeros). kK / 8 consecutive threads copy one row, as load_tile_async;
// `tid` (0 .. kThreads - 1) is this thread's place among the kThreads that
// copy the tile. The exact build's overlay load.
template <int D>
__device__ __forceinline__ void load_overlay_async(__nv_bfloat16* dst,
                                                   const __nv_bfloat16* __restrict__ src,
                                                   int r0, int T, int row_from, unsigned tid) {
  using G = Dims<D>;
  constexpr int kChunks = G::kK / 8;
#pragma unroll
  for (int i = 0; i < kTile * kChunks / kThreads; ++i) {
    const unsigned idx = tid + i * kThreads;
    const int row = static_cast<int>(idx / kChunks);
    const int col = static_cast<int>(idx % kChunks) * 8;
    if (row < row_from) continue;
    const bool valid = r0 + row < T && col < D;
    cp_async16(dst + row * G::kLd + col,
               src + (valid ? static_cast<size_t>(r0 + row) * D + col : 0), valid);
  }
}

// The padded build's load of rows [row_from, kTile) of a tile whose row r
// is row r0 + r of a (T, dh) bf16 matrix (the chunk's q rows, or its own k/v), dh <= D: by cp.async,
// 16 bytes a copy, where rows start on 16 bytes (dh a multiple of 8; the
// wrapper checks the tensors' alignment), else value by value (rows of an
// odd dh, say 9, are not 16-byte aligned). Rows below row_from hold context
// keys and are left alone; rows at or past T and head dims at or past dh
// read as zeros. In the vector path kK / 8 consecutive threads copy one
// row, as load_tile_async; `tid` (0 .. kThreads - 1) is this thread's place
// among the kThreads that copy the tile.
template <int D>
__device__ __forceinline__ void load_rows_dh(__nv_bfloat16* dst,
                                             const __nv_bfloat16* __restrict__ src, int r0,
                                             int T, int dh, int row_from, unsigned tid) {
  using G = Dims<D>;
  if (dh % 8 == 0) {
    constexpr int kChunks = G::kK / 8;
#pragma unroll
    for (int i = 0; i < kTile * kChunks / kThreads; ++i) {
      const unsigned idx = tid + i * kThreads;
      const int row = static_cast<int>(idx / kChunks);
      const int col = static_cast<int>(idx % kChunks) * 8;
      if (row < row_from) continue;
      const bool valid = r0 + row < T && col < dh;
      cp_async16(dst + row * G::kLd + col,
                 src + (valid ? static_cast<size_t>(r0 + row) * dh + col : 0), valid);
    }
  } else {
    for (unsigned idx = tid; idx < kTile * G::kK; idx += kThreads) {
      const int row = static_cast<int>(idx / G::kK);
      const int col = static_cast<int>(idx % G::kK);
      if (row < row_from) continue;
      dst[row * G::kLd + col] = r0 + row < T && col < dh
                                    ? src[static_cast<size_t>(r0 + row) * dh + col]
                                    : __float2bfloat16_rn(0.f);
    }
  }
}

// The padded build's store: a warp's head-dim-wide accumulator, rows
// row0 + 0..15 (those < T), columns < dh, to a (T, dh) bf16 matrix: a bf16 pair a store where dh is
// even (the pair then starts on 4 bytes), one value a store where it is odd.
template <int D>
__device__ __forceinline__ void store_acc_dh(__nv_bfloat16* __restrict__ dst,
                                             const float (&c)[Dims<D>::kN][4], int row0, int T,
                                             int dh) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + (lane >> 2) + 8 * h;
    if (row >= T) continue;
    __nv_bfloat16* out = dst + static_cast<size_t>(row) * dh;
#pragma unroll
    for (int n = 0; n < Dims<D>::kN; ++n) {
      const int col = n * 8 + 2 * (lane & 3);
      if (col >= dh) continue;
      if (dh % 2 == 0) {
        *reinterpret_cast<uint32_t*>(out + col) = pack_bf16(c[n][2 * h], c[n][2 * h + 1]);
      } else {
        out[col] = __float2bfloat16_rn(c[n][2 * h]);
        if (col + 1 < dh) out[col + 1] = __float2bfloat16_rn(c[n][2 * h + 1]);
      }
    }
  }
}

// One block an SM is all the launch bound asks for: given only 256 threads,
// ptxas held the two-tile kernels to 128 registers and spilled.
template <int MODE, int D, int R>
__global__ void __launch_bounds__(kThreads * R, 1) paged_chunk_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kc,
    const __nv_bfloat16* __restrict__ vc, const void* __restrict__ k_pool,
    const void* __restrict__ v_pool, const void* __restrict__ k_scale,
    const void* __restrict__ v_scale, const int32_t* __restrict__ table,
    const int32_t* __restrict__ lens, __nv_bfloat16* __restrict__ out, int H,
    int Hkv, int W, int dh_arg, int page, int N, int P, int live_pages, int ctx_len,
    int window, float sqrt_dh, int vec, int plant) {
  using Dm = Dims<D>;
  // the true head dim: a compile-time constant in the exact build
  const int dh = kPadded ? dh_arg : D;
  using T = typename Elem<MODE>::T;
  constexpr int kHalf = kRuns<D> / 2;
  const int s = blockIdx.x;
  const int kvh = blockIdx.y;
  const int G = H / Hkv;
  const int GW = G * W;
  const int r0 = blockIdx.z * kTile * R;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w0 = (tid >> 5) * 16;  // this warp's rows
  // the 8-key runs of a context tile this warp stages (16 keys with one
  // row tile a block, 8 with two), from key kw0 of the tile
  constexpr int k_groups = 2 / R;
  const int kw0 = (tid >> 5) * 8 * k_groups;
  const unsigned wg_tid = tid % kThreads;  // place in this warp's group of 4
  const int wg = R == 1 ? 0 : tid / kThreads;
  // tiles hold positions [64 i - shift, 64 i + 64 - shift): shift is 0 but
  // in the test-only control's block
  const int shift =
      plant >= 0 && s == 0 && kvh == 0 && plant / (kTile * R) == static_cast<int>(blockIdx.z)
          ? 32
          : 0;
  const T* kp = static_cast<const T*>(k_pool);
  const T* vp = static_cast<const T*>(v_pool);

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);  // (row, d)
  __nv_bfloat16* k_s = q_s + R * Dm::kElems;                     // [2] (key, d)
  __nv_bfloat16* v_s = k_s + 2 * Dm::kElems;                     // [2] (key, d)

  // q and out (S, H, W, dh): this kv head's G*W rows are contiguous
  const size_t qo_base = (static_cast<size_t>(s) * H + static_cast<size_t>(kvh) * G) * W * dh;
  const size_t c_base = (static_cast<size_t>(s) * Hkv + kvh) * W * dh;  // chunk k/v
  if (dh < Dm::kK) {
    // head dims past dh of the staged k/v tiles stay zero: the context path
    // writes only d < dh (the q and overlay loads zero-fill theirs)
    const int pad = Dm::kK - dh;
    for (int i = tid; i < 4 * kTile * pad; i += blockDim.x) {
      k_s[(i / pad) * Dm::kLd + dh + i % pad] = __float2bfloat16_rn(0.f);
    }
  }
  // each group of 4 warps its own 64 query rows
  if constexpr (kPadded) {
    load_rows_dh<D>(q_s + wg * Dm::kElems, q + qo_base, r0 + wg * kTile, GW, dh, 0, wg_tid);
  } else {
    load_tile_async<D>(q_s + wg * Dm::kElems, q + qo_base, r0 + wg * kTile, GW, wg_tid);
  }

  const int len = max(lens[s], 0);
  // the positions of this thread's two fragment rows (g, g + 8); -1 past the end
  int qpos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gr = r0 + w0 + (lane >> 2) + 8 * h;
    qpos[h] = gr < GW ? len + gr % W : -1;
  }
  // the block's smallest and largest chunk row
  const int r_last = min(r0 + kTile * R, GW) - 1;
  int jmin = r0 % W, jmax = r_last % W;
  if (r0 / W != r_last / W) {
    jmin = 0;
    jmax = W - 1;
  }
  const int hi = min(len, ctx_len);  // committed context: [lo, hi)
  const int lo = window > 0 ? (max(len - (window - 1), 0) / page) * page : 0;
  const int w_valid = max(min(W, ctx_len - len), 0);  // overlay rows inside ctx_len
  // live keys: [lo, hi) from the pages, [len, len + w_valid) from the chunk;
  // tiles from the one holding lo to the one holding the last position
  // some row of the block can see
  const int t_first = (lo + shift) / kTile;
  const int last_pos = min(len + jmax, max(hi, len + w_valid) - 1);
  const int n_tiles =
      last_pos >= t_first * kTile - shift ? (last_pos + shift) / kTile - t_first + 1 : 0;

  // tile t's first position (negative only in the control's first tile:
  // such keys are never read and always masked), and how many of its rows
  // are context keys
  auto base_of = [&](int t) { return (t_first + t) * kTile - shift; };
  auto ctx_rows = [&](int base) { return min(max(len - base, 0), kTile); };
  // the first tile at or after t that holds a live key some row can see
  auto next_live = [&](int t) {
    for (; t < n_tiles; ++t) {
      const int base = base_of(t);
      const int last = base + kTile - 1;
      if (base >= hi && (last < len || base >= len + w_valid)) continue;  // no live key
      if (window > 0 && last <= len + jmin - window) continue;  // before every row's window
      if (base > len + jmax) continue;                            // after every row
      break;
    }
    return t;
  };

  // the next context tile's values, in registers between its loads and its
  // store into shared memory: k and v runs, and the scale of key kw0 + lane
  // (lanes 0-15 k's, 16-31 v's)
  constexpr int kW = kRunWords<MODE>;
  uint32_t rk[kRuns<D>][kW], rv[kRuns<D>][kW];
  float rsc = 1.f;
  auto fetch_ctx = [&](int base) {
#pragma unroll
    for (int gg = 0; gg < 2; ++gg) {
      if (gg >= k_groups) continue;        // warp-uniform
      const int p0 = base + kw0 + 8 * gg;  // the run's first position
      const int col = p0 / page;
      // unsigned: a run at negative positions (the control's) is not read
      const bool whole = vec && static_cast<unsigned>(p0 + 7) < static_cast<unsigned>(hi) &&
                         col < live_pages;
      const size_t pg = whole ? static_cast<size_t>(min(max(table[static_cast<size_t>(s) * P + col], 0), N - 1))
                              : 0;
#pragma unroll
      for (int m = 0; m < kHalf; ++m) {
        const int c = gg * kHalf + m;
        const int d = lane + 32 * m;
#pragma unroll
        for (int w = 0; w < kW; ++w) rk[c][w] = rv[c][w] = 0u;
        if (d >= dh) continue;
        if (whole) {
          const size_t e = ((pg * Hkv + kvh) * dh + d) * page + (p0 - col * page);
          load_run<MODE>(rk[c], kp + e);
          load_run<MODE>(rv[c], vp + e);
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int p = p0 + j;
            const int pc = p / page;
            if (static_cast<unsigned>(p) < static_cast<unsigned>(hi) && pc < live_pages) {
              const size_t src = min(max(table[static_cast<size_t>(s) * P + pc], 0), N - 1);
              const size_t e = ((src * Hkv + kvh) * dh + d) * page + (p - pc * page);
              run_set<MODE>(rk[c], j, kp[e]);
              run_set<MODE>(rv[c], j, vp[e]);
            }
          }
        }
      }
    }
    if (MODE != kBf16) {
      const int p = base + kw0 + (lane & 15);
      const int pc = p / page;
      rsc = 1.f;
      if (static_cast<unsigned>(p) < static_cast<unsigned>(hi) && pc < live_pages) {
        const size_t src = min(max(table[static_cast<size_t>(s) * P + pc], 0), N - 1);
        rsc = load_scale<MODE>(lane < 16 ? k_scale : v_scale,
                               (src * Hkv + kvh) * page + (p - pc * page));
      }
    }
  };
  // rows [0, n_rows) of the context tile in registers into stage st:
  // dequantized, [key][d] (the rest of a straddling tile is the overlay's;
  // `whole` is Whole<true> when n_rows is kTile)
  auto store_ctx = [&](int st, int n_rows, auto whole) {
    __nv_bfloat16* kt = k_s + st * Dm::kElems;
    __nv_bfloat16* vt = v_s + st * Dm::kElems;
#pragma unroll
    for (int gg = 0; gg < 2; ++gg)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (gg >= k_groups) continue;                                          // warp-uniform
        if (!decltype(whole)::kValue && kw0 + 8 * gg + j >= n_rows) continue;  // warp-uniform
        const float sk = MODE == kBf16 ? 1.f : __shfl_sync(0xffffffffu, rsc, 8 * gg + j);
        const float sv = MODE == kBf16 ? 1.f : __shfl_sync(0xffffffffu, rsc, 16 + 8 * gg + j);
        const int row = (kw0 + 8 * gg + j) * Dm::kLd;
#pragma unroll
        for (int m = 0; m < kHalf; ++m) {
          const int d = lane + 32 * m;
          if (d >= dh) continue;
          kt[row + d] = dequant<MODE>(run_elem<MODE>(rk[gg * kHalf + m], j), sk);
          vt[row + d] = dequant<MODE>(run_elem<MODE>(rv[gg * kHalf + m], j), sv);
        }
      }
  };
  // tile t's loads: its context rows into registers, its overlay rows by
  // cp.async into stage st (chunk rows at or past w_valid zero-filled; k by
  // the first group of 4 warps, v by the last)
  auto start_loads = [&](int t, int st) {
    const int base = base_of(t);
    const int c = ctx_rows(base);
    if (c > 0) fetch_ctx(base);
    if (c < kTile) {
      if (wg == 0) {
        if constexpr (kPadded) {
          load_rows_dh<D>(k_s + st * Dm::kElems, kc + c_base, base - len, w_valid, dh, c,
                          wg_tid);
        } else {
          load_overlay_async<D>(k_s + st * Dm::kElems, kc + c_base, base - len, w_valid, c,
                                wg_tid);
        }
      }
      if (wg == R - 1) {
        if constexpr (kPadded) {
          load_rows_dh<D>(v_s + st * Dm::kElems, vc + c_base, base - len, w_valid, dh, c,
                          wg_tid);
        } else {
          load_overlay_async<D>(v_s + st * Dm::kElems, vc + c_base, base - len, w_valid, c,
                                wg_tid);
        }
      }
    }
    cp_async_commit();
  };

  float acc[Dm::kN][4];
#pragma unroll
  for (int n = 0; n < Dm::kN; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = kNegInf, l0 = 0.f, m1 = kNegInf, l1 = 0.f;  // rows g and g + 8

  int t = next_live(0);
  if (t < n_tiles) start_loads(t, 0);
  for (int i = 0; t < n_tiles; ++i) {
    const int st = i & 1;
    const int base = base_of(t);
    const int c = ctx_rows(base);
    // stage st was last read two tiles ago, before the previous barrier
    if (c == kTile) {
      store_ctx(st, c, Whole<true>{});
    } else if (c > 0) {
      store_ctx(st, c, Whole<false>{});
    }
    cp_async_wait<0>();
    // tile t is in; every warp is done with the previous tile's stage
    __syncthreads();
    const int nt = next_live(t + 1);
    if (nt < n_tiles) start_loads(nt, st ^ 1);

    uint32_t qa[Dm::kSteps][4];
    load_a<D>(qa, q_s, w0);
    float sc[8][4];
    zero(sc);
    mma_abt<D>(sc, qa, k_s + st * Dm::kElems);  // q k^T, f32 sums
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pos = base + frag_col(n, e);
        // a page key in [0, hi), or a chunk key in [len, len + w_valid)
        const bool key = static_cast<unsigned>(pos) < static_cast<unsigned>(hi) ||
                         static_cast<unsigned>(pos - len) < static_cast<unsigned>(w_valid);
        const int qp = qpos[e >> 1];
        const bool ok = qp >= 0 && key && pos <= qp && (window <= 0 || pos > qp - window);
        sc[n][e] = ok ? round_bf16(sc[n][e]) / sqrt_dh : kNegInf;
      }
    online_softmax(sc, acc, 0, m0, l0);
    online_softmax(sc, acc, 1, m1, l1);
    uint32_t pa[4][4];
    to_a(pa, sc);                                // p rounded to bf16
    mma_ab<D>(acc, pa, v_s + st * Dm::kElems);   // acc += p v
    t = nt;
  }
  cp_async_wait<0>();  // the q tile's copy, when no tile was live

  normalize(acc, 0, l0);
  normalize(acc, 1, l1);
  if constexpr (kPadded) {
    store_acc_dh<D>(out + qo_base, acc, r0 + w0, GW, dh);
  } else {
    store_acc<D>(out + qo_base, acc, r0 + w0, GW);
  }
}

template <int DH, int R>
auto kernel_for(int mode) -> decltype(&paged_chunk_kernel<kBf16, DH, R>) {
  switch (mode) {
    case kBf16: return paged_chunk_kernel<kBf16, DH, R>;
    case kInt8: return paged_chunk_kernel<kInt8, DH, R>;
    case kFp8: return paged_chunk_kernel<kFp8, DH, R>;
    default: return nullptr;
  }
}

template <int DH, int R>
int launch(int mode, const void* q, const void* kc, const void* vc, const void* k_pool,
           const void* v_pool, const void* k_scale, const void* v_scale, const void* table,
           const void* lens, void* out, int S, int H, int Hkv, int W, int dh, int page,
           int N, int P, int live_pages, int ctx_len, int window, float sqrt_dh, int plant,
           cudaStream_t stream) {
  const auto kernel = kernel_for<DH, R>(mode);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem_bytes<DH>(R)));
  if (err != cudaSuccess) return static_cast<int>(err);
  // runs of 8 keys load as one vector when they stay inside a page and the
  // pools are aligned for it (16 bytes bf16, 8 int8/fp8)
  const uintptr_t align = mode == kBf16 ? 16 : 8;
  const int vec = page % 8 == 0 && reinterpret_cast<uintptr_t>(k_pool) % align == 0 &&
                  reinterpret_cast<uintptr_t>(v_pool) % align == 0;
  const int rows = kTile * R;
  const dim3 grid(S, Hkv, (H / Hkv * W + rows - 1) / rows);
  kernel<<<grid, kThreads * R, smem_bytes<DH>(R), stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(kc),
      static_cast<const __nv_bfloat16*>(vc), k_pool, v_pool, k_scale, v_scale,
      static_cast<const int32_t*>(table), static_cast<const int32_t*>(lens),
      static_cast<__nv_bfloat16*>(out), H, Hkv, W, dh, page, N, P, live_pages, ctx_len,
      window, sqrt_dh, vec, plant);
  return static_cast<int>(cudaGetLastError());
}

template <int DH, int R>
int resources(int mode, int* out) {
  const auto kernel = kernel_for<DH, R>(mode);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return kernel_resources(kernel, smem_bytes<DH>(R), out, kThreads * R);
}

// one instantiation set per row-tile count
template <int DH>
int launch_rows(int row_tiles, int mode, const void* q, const void* kc, const void* vc,
                const void* k_pool, const void* v_pool, const void* k_scale,
                const void* v_scale, const void* table, const void* lens, void* out, int S,
                int H, int Hkv, int W, int dh, int page, int N, int P, int live_pages,
                int ctx_len, int window, float sqrt_dh, int plant, cudaStream_t stream) {
#define PAGED_CHUNK_ARGS mode, q, kc, vc, k_pool, v_pool, k_scale, v_scale, table, lens, out, \
    S, H, Hkv, W, dh, page, N, P, live_pages, ctx_len, window, sqrt_dh, plant, stream
  switch (row_tiles) {
    case 1: return launch<DH, 1>(PAGED_CHUNK_ARGS);
    case 2: return launch<DH, 2>(PAGED_CHUNK_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PAGED_CHUNK_ARGS
}

template <int DH>
int resources_rows(int row_tiles, int mode, int* out) {
  switch (row_tiles) {
    case 1: return resources<DH, 1>(mode, out);
    case 2: return resources<DH, 2>(mode, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// mode: 0 bf16 pools, 1 int8 pools with f32 scales, 2 fp8 e4m3 pools with
// uint8 E8M0 scales. q, kc, vc and out bf16, contiguous, 16-byte aligned.
// Dh is the true head dim: the pools, q, the chunk and out are all Dh
// wide. width (8, 16, 32, 64 or 128) is the instantiation the launch runs:
// Dh itself in this build, at least Dh in the padded one (the module
// notes). window <= 0 means none. row_tiles (1 or 2):
// 64-row query tiles a block; every value gives the same bits. plant: -1,
// or the test-only control's row (see the notes at the top).
// Returns cudaGetLastError() (or cudaErrorInvalidValue for a refused shape).
int paged_chunk_launch(const void* q, const void* kc, const void* vc,
                       const void* k_pool, const void* v_pool, const void* k_scale,
                       const void* v_scale, const void* table, const void* lens,
                       void* out, int S, int H, int Hkv, int W, int Dh, int width,
                       int page, int N, int P, int live_pages, int ctx_len, int window,
                       int mode, int row_tiles, int plant, float sqrt_dh, void* stream) {
  if (Dh < 1 || Dh > width || (!kPadded && Dh != width) || Hkv < 1 || H % Hkv ||
      page < 1 || N < 1 || P < 1 ||
      live_pages < 0 || live_pages > P || ctx_len < P * page || row_tiles < 1 ||
      row_tiles > kMaxRowTiles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (S == 0 || W == 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
#define PAGED_CHUNK_ARGS row_tiles, mode, q, kc, vc, k_pool, v_pool, k_scale, v_scale, table, \
    lens, out, S, H, Hkv, W, Dh, page, N, P, live_pages, ctx_len, window, sqrt_dh, plant, st
  switch (width) {
    case 8: return launch_rows<8>(PAGED_CHUNK_ARGS);
    case 16: return launch_rows<16>(PAGED_CHUNK_ARGS);
    case 32: return launch_rows<32>(PAGED_CHUNK_ARGS);
    case 64: return launch_rows<64>(PAGED_CHUNK_ARGS);
    case 128: return launch_rows<128>(PAGED_CHUNK_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PAGED_CHUNK_ARGS
}

// What the kernel of pool mode `mode` takes on this card at the width
// (8, 16, 32, 64 or 128), launched with `row_tiles` row tiles a block:
// out[0] registers a thread, out[1] local (spilled) bytes a thread, out[2]
// dynamic shared memory a block, out[3] resident blocks an SM.
int paged_chunk_resources(int mode, int width, int row_tiles, int* out) {
  switch (width) {
    case 8: return resources_rows<8>(row_tiles, mode, out);
    case 16: return resources_rows<16>(row_tiles, mode, out);
    case 32: return resources_rows<32>(row_tiles, mode, out);
    case 64: return resources_rows<64>(row_tiles, mode, out);
    case 128: return resources_rows<128>(row_tiles, mode, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
