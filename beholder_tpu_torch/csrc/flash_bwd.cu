// Flash attention backward for Hopper (sm_90a): the dq kernel and the dk/dv
// kernel, bound through a plain C interface (ctypes) by
// beholder_tpu_torch/ops/flash_attention.py.
//
// Replaces the TPU kernels beholder_tpu/ops/flash_attention.py::_dq_kernel
// and ::_dkv_kernel (launched by _flash_bwd_padded, the backward of the
// custom VJP _flash). Both recompute the probabilities from the forward's
// saved logsumexp, p = exp(s - lse), so the (T, T) matrix never exists.
//
// What bounds them: operations. At the training shape (B=4, H=8, Hkv=2,
// T=4096, Dh=64, causal), dq runs three products (scores, dp = do v^T, dq =
// ds k), 103 GFLOP or 0.104 ms at the bf16 tensor-core rate; dk/dv four
// (scores, dp, dv = p^T do, dk = ds^T q), 137 GFLOP or 0.139 ms. The bytes
// (q, k, v, o, do, lse, delta, and the gradients) are below 0.02 ms.
//
// Route: every product is mma.sync.aligned.m16n8k16 with bf16 operands and
// f32 accumulators (flash_mma.cuh), operands read by ldmatrix from bf16
// shared memory, ldmatrix.trans for those read transposed. No wgmma, no
// TMA. What bounds the kernels now is not the tensor cores: each warp reads
// every streamed tile through ldmatrix once per product (shared-memory
// bandwidth), and the exp, mask and ds arithmetic between the products runs
// on the ordinary f32 units, 32 elements a thread a tile.
//
// The design:
// - One warpgroup (4 warps, 128 threads) per block; each warp owns 16 rows
//   of a 64-row resident tile.
// - dq: one block per (batch*head, 64-row q tile); the grid runs every
//   head's longest tile (the last under causal) first. The q and do
//   fragments stay in registers, lse and delta of the warp's rows too; the
//   live 64-key tiles of k and v stream through.
// - dk/dv: one block per (batch*kv head, 64-key tile); the grid runs every
//   head's key tile 0 (the most rows under causal) first. The k and v
//   fragments stay in registers; the live q tiles of each of the GQA
//   group's G query heads stream through with q, do, lse, delta and
//   segment ids. Keys are the M dimension: s^T =
//   k q^T and dp^T = v do^T, then dv += p^T do and dk += ds^T q.
// - p and ds never touch shared memory: the f32 accumulator fragments of
//   s and dp become, rounded to bf16, the A fragments of the next product
//   (flash_mma.cuh to_a). That conversion is where p and ds are rounded.
// - Streamed tiles are bf16 in shared memory, rows padded to 144 bytes
//   (ldmatrix without bank conflicts), double-buffered: cp.async brings
//   tile j+1 while tile j computes. About 37 KB a block at head dim 64, so
//   registers set the occupancy: dq is held to 168 registers a thread (3
//   blocks an SM), dk/dv, which keeps two more accumulators, to 255 (2
//   blocks an SM). Head dim 128 below.
// - Tiles are live only: the causal diagonal and the window bound each
//   loop, and the per-element mask runs only where it can bite.
// - Head dims 8, 16, 32, 64 and 128, one instantiation each (flash_mma.cuh
//   Dims): the two products that sum over the head dim (scores, dp) take it
//   in 16-wide mma steps, D = 8 zero-padded to 16 in shared memory by
//   cp.async; the products whose output is head-dim wide (dq, dk, dv) take
//   n8 column tiles, so their accumulators shrink with D.
// - Head dim 128, the reference's bench_flash_attention width, does not fit
//   that register budget: one f32 accumulator of a 16-row warp slice is 64
//   registers a thread there, dk/dv keep two of them beside the resident k
//   and v fragments (32 each) and the s and dp tiles (32 each), well past
//   255. The ways out: dk and dv in two passes; the accumulators split
//   across two warpgroups; operands kept in shared memory. dk/dv at 128
//   splits the accumulators across two warpgroups by output rather than by
//   head dim, with k and v in shared memory, which keeps the loads and the
//   extra work smallest: two warpgroups (256 threads) over the same 64
//   keys, the first summing dv, the second dk, each one accumulator. Both
//   read the same streamed q and do tiles, loaded once for the block; the
//   first recomputes the score product that the second also runs for ds,
//   so a tile costs five products instead of four (the two-pass split
//   costs five too, and streams q and do twice; splitting the head dim
//   costs six). k and v stay in shared memory and reach the products one
//   16-wide step at a time (flash_mma.cuh mma_abt_s), as q and do do in
//   dq at 128, whose single accumulator then fits beside s and dp. Both
//   kernels at 128 run two warpgroups' worth of registers an SM: dq two
//   128-thread blocks (105 KB of shared memory each), dk/dv one 256-thread
//   block.
// - Ring block-pair mode (the TPU kernels' pallas_calls with qoff/kvoff, as
//   flash_block_backward launches them): the C entries take q_offset and
//   kv_offset, the masks shift the diagonal by delta = q_offset - kv_offset
//   (flash_common.cuh), and each block works out its live tiles from the
//   shifted diagonal. A block with none writes zeros. Under a fully live
//   off-axis pair every dk/dv block streams the same number of tiles, so the
//   heaviest-first order has nothing to balance. The lse is the ring's
//   global one, so a row dead in this pair recomputes p = 0.
// - No atomics and no float sum whose order depends on scheduling: each
//   block owns its output rows, dq sums its key tiles in order, and dk/dv
//   sum the whole GQA group in registers, query head by query head, and
//   round once. Two launches on the same inputs give the same bits, which
//   a bitwise checkpoint resume needs. (The TPU version writes per-q-head
//   partials in k's dtype and sums them in XLA.)
//
// The arithmetic follows the TPU kernels: s = (q k^T) * scale in f32 with q
// unscaled; masked to -1e30; p = exp(s - lse), zeroed where the score is
// masked (a row with no live key carries lse = -1e30); a query row past T
// carries lse = +1e30 so its p is exactly 0; ds = p * (dp - delta) * scale;
// ds is rounded to bf16 before the dq and dk products, p before the dv
// product; dq, dk and dv are summed in f32 and written in bf16.
// delta = rowsum(do * o) in f32 comes in precomputed (plain torch, as the
// reference computes it in XLA).

#include "flash_mma.cuh"

namespace {

using namespace flash;

// whether the resident operands (dq: q and do; dk/dv: k and v) stay in
// shared memory rather than in registers, and dk/dv runs as two warpgroups
template <int D>
constexpr bool kWide = D == 128;

// two stages of two bf16 tiles, then (at 128) the two resident tiles, then
// segment ids (dq: the resident rows' and two stages of keys'; dk/dv: two
// stages of rows' and the resident keys'), then (dk/dv) two stages of lse
// and delta
template <int D>
constexpr size_t kTileBytes = sizeof(__nv_bfloat16) * Dims<D>::kElems;
template <int D>
constexpr size_t kDqSmemBytes = (kWide<D> ? 6 : 4) * kTileBytes<D> + sizeof(int) * 3 * kTile;
template <int D>
constexpr size_t kDkvSmemBytes = (kWide<D> ? 6 : 4) * kTileBytes<D> +
                                 sizeof(int) * 3 * kTile + sizeof(float) * 4 * kTile;
// at most 48 KB a block below 128: 4 blocks fit an SM's shared memory, so
// registers, not shared memory, set the occupancy; at 128 two dq blocks
// fit an SM
static_assert(kDkvSmemBytes<64> <= 48 * 1024 && kDqSmemBytes<64> <= 48 * 1024,
              "shared memory would limit the occupancy");
static_assert(2 * kDqSmemBytes<128> <= 227 * 1024, "two dq blocks an SM at head dim 128");

// registers cap: 168 a thread (3 blocks an SM) below 128, 255 (2) at 128
template <int D>
constexpr int kDqMinBlocks = kWide<D> ? 2 : 3;
// the dk/dv kernel's threads: two warpgroups at 128
template <int D>
constexpr int kDkvThreads = kWide<D> ? 2 * kThreads : kThreads;

template <int D>
__global__ void __launch_bounds__(kThreads, kDqMinBlocks<D>) flash_dq_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int32_t* __restrict__ seg, __nv_bfloat16* __restrict__ dq, int T, int G,
    int H, int causal, int window, int shift, float scale) {
  using Dm = Dims<D>;
  const int n_tiles = (T + kTile - 1) / kTile;
  const int r0 = (n_tiles - 1 - static_cast<int>(blockIdx.y)) * kTile;
  const int bh = blockIdx.x;
  const int w0 = (threadIdx.x >> 5) * 16;  // this warp's rows in the tile
  const int r_last = min(r0 + kTile, T) - 1;
  const bool has_seg = seg != nullptr;

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);  // [2] (key, d)
  __nv_bfloat16* vs = ks + 2 * Dm::kElems;                      // [2] (key, d)
  // q and do: at 128 resident here, below it through the second stage
  __nv_bfloat16* qr = kWide<D> ? vs + 2 * Dm::kElems : ks + Dm::kElems;
  __nv_bfloat16* dr = kWide<D> ? qr + Dm::kElems : vs + Dm::kElems;
  int* qseg = reinterpret_cast<int*>(vs + (kWide<D> ? 4 : 2) * Dm::kElems);  // (row,)
  int* kseg = qseg + kTile;                                                  // [2] (key,)

  const size_t q_off = static_cast<size_t>(bh) * T * D;
  const size_t kv_off = static_cast<size_t>(bh / G) * T * D;
  const int32_t* seg_b = has_seg ? seg + static_cast<size_t>(bh / H) * T : nullptr;
  // an empty range (j_lo > j_hi): a dead block pair, no key is live for
  // these rows; the loop does not run and their dq is written as zeros
  const Tiles tiles = key_tiles(r0, r_last, n_tiles, causal, window, shift);
  const int j_lo = tiles.lo, j_hi = tiles.hi;
  const int r0d = r0 + shift;  // the resident tile's first row, shifted

  // q and do to their tiles; the first key tile goes to the first stage
  load_tile_async<D>(qr, q + q_off, r0, T);
  load_tile_async<D>(dr, dout + q_off, r0, T);
  load_tile_async<D>(ks, k + kv_off, j_lo * kTile, T);
  load_tile_async<D>(vs, v + kv_off, j_lo * kTile, T);
  if (has_seg) {
    load_vec_async(qseg, seg_b, r0, T, -1, 0);
    load_vec_async(kseg, seg_b, j_lo * kTile, T, -1, kTile);
  }
  cp_async_commit();
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + w0 + frag_row(2 * h);
    lse_r[h] = row < T ? lse[static_cast<size_t>(bh) * T + row] : kPadLse;
    delta_r[h] = row < T ? delta[static_cast<size_t>(bh) * T + row] : 0.f;
  }
  cp_async_wait<0>();
  __syncthreads();
  // below 128 the q and do fragments stay in registers
  uint32_t qa[kWide<D> ? 1 : Dm::kSteps][4], doa[kWide<D> ? 1 : Dm::kSteps][4];
  if constexpr (!kWide<D>) {
    load_a<D>(qa, qr, w0);
    load_a<D>(doa, dr, w0);
    __syncthreads();  // the second stage is free
  }

  float acc[Dm::kN][4];
#pragma unroll
  for (int n = 0; n < Dm::kN; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  for (int j = j_lo; j <= j_hi; ++j) {
    const int st = (j - j_lo) & 1;
    if (j < j_hi) {
      const int nx = st ^ 1;
      load_tile_async<D>(ks + nx * Dm::kElems, k + kv_off, (j + 1) * kTile, T);
      load_tile_async<D>(vs + nx * Dm::kElems, v + kv_off, (j + 1) * kTile, T);
      if (has_seg) load_vec_async(kseg + nx * kTile, seg_b, (j + 1) * kTile, T, -1, 0);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* kt = ks + st * Dm::kElems;
    const int c0 = j * kTile;

    float s[8][4], dp[8][4];
    zero(s);
    zero(dp);
    if constexpr (kWide<D>) {
      mma_abt_s<D>(s, qr, w0, kt);                      // q k^T
      mma_abt_s<D>(dp, dr, w0, vs + st * Dm::kElems);  // do v^T
    } else {
      mma_abt<D>(s, qa, kt);                      // q k^T
      mma_abt<D>(dp, doa, vs + st * Dm::kElems);  // do v^T
    }
    const bool masked = needs_mask(r0d, c0, T, causal, window, has_seg);
    const int* kseg_t = kseg + st * kTile;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ri = w0 + frag_row(e), ci = frag_col(n, e);
        float x = s[n][e] * scale;
        if (masked && !live(r0d + ri, c0 + ci, T, causal, window, has_seg ? qseg : nullptr,
                            kseg_t, ri, ci)) {
          x = kNegInf;
        }
        float p = expf(x - lse_r[e >> 1]);
        if (x <= kNegInf * 0.5f) p = 0.f;
        s[n][e] = p * (dp[n][e] - delta_r[e >> 1]) * scale;  // ds
      }
    uint32_t dsa[4][4];
    to_a(dsa, s);             // ds rounded to bf16
    mma_ab<D>(acc, dsa, kt);  // dq += ds k
    __syncthreads();          // this stage's readers are done before it refills
  }
  store_acc<D>(dq + q_off, acc, r0 + w0, T);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2) flash_dkv_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int32_t* __restrict__ seg, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int T, int G, int Hkv, int causal, int window,
    int shift, float scale) {
  using Dm = Dims<D>;
  const int n_tiles = (T + kTile - 1) / kTile;
  const int c0 = blockIdx.y * kTile;  // tile 0 sees the most rows under causal
  const int bhkv = blockIdx.x;
  const int w0 = (threadIdx.x >> 5) * 16;  // this warp's keys in the tile
  const int c_last = min(c0 + kTile, T) - 1;
  const bool has_seg = seg != nullptr;

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);  // [2] (row, d)
  __nv_bfloat16* dos = qs + 2 * Dm::kElems;                     // [2] (row, d)
  int* qseg = reinterpret_cast<int*>(dos + 2 * Dm::kElems);     // [2] (row,)
  int* kseg = qseg + 2 * kTile;                                 // (key,)
  float* lse_s = reinterpret_cast<float*>(kseg + kTile);        // [2] (row,)
  float* delta_s = lse_s + 2 * kTile;                           // [2] (row,)

  const size_t kv_off = static_cast<size_t>(bhkv) * T * D;
  const int32_t* seg_b = has_seg ? seg + static_cast<size_t>(bhkv / Hkv) * T : nullptr;
  const Tiles tiles = query_tiles(c0, c_last, n_tiles, causal, window, shift);
  const int i_lo = tiles.lo;
  const int n_rows = tiles.hi - i_lo + 1;  // live row tiles per query head
  const int n_steps = G * n_rows;
  if (n_rows <= 0) {  // a dead block pair: no query row sees these keys
    store_zeros<D>(dk + kv_off, c0 + w0, T);
    store_zeros<D>(dv + kv_off, c0 + w0, T);
    return;
  }

  // step i of the stream: query head bhkv * G + i / n_rows, row tile
  // i_lo + i % n_rows, into stage st
  auto load_step = [&](int i, int st) {
    const int bh = bhkv * G + i / n_rows;
    const int r0 = (i_lo + i % n_rows) * kTile;
    const size_t q_off = static_cast<size_t>(bh) * T * D;
    load_tile_async<D>(qs + st * Dm::kElems, q + q_off, r0, T);
    load_tile_async<D>(dos + st * Dm::kElems, dout + q_off, r0, T);
    load_vec_async(lse_s + st * kTile, lse + static_cast<size_t>(bh) * T, r0, T, kPadLse, 0);
    load_vec_async(delta_s + st * kTile, delta + static_cast<size_t>(bh) * T, r0, T, 0.f, kTile);
    if (has_seg) load_vec_async(qseg + st * kTile, seg_b, r0, T, -1, 0);
  };

  // k and v pass through the second stage's slots; step 0 goes to the first
  load_tile_async<D>(qs + Dm::kElems, k + kv_off, c0, T);
  load_tile_async<D>(dos + Dm::kElems, v + kv_off, c0, T);
  if (has_seg) load_vec_async(kseg, seg_b, c0, T, -1, kTile);
  load_step(0, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t ka[Dm::kSteps][4], va[Dm::kSteps][4];
  load_a<D>(ka, qs + Dm::kElems, w0);
  load_a<D>(va, dos + Dm::kElems, w0);
  __syncthreads();  // the second stage is free

  float dk_acc[Dm::kN][4], dv_acc[Dm::kN][4];
#pragma unroll
  for (int n = 0; n < Dm::kN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;
  for (int i = 0; i < n_steps; ++i) {
    const int st = i & 1;
    if (i + 1 < n_steps) {
      load_step(i + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* qt = qs + st * Dm::kElems;
    const __nv_bfloat16* dot = dos + st * Dm::kElems;
    const float* lse_t = lse_s + st * kTile;
    const float* delta_t = delta_s + st * kTile;
    const int r0d = (i_lo + i % n_rows) * kTile + shift;  // the row tile, shifted

    // transposed scores: the warp's 16 keys by the tile's 64 rows
    float s[8][4], dp[8][4];
    zero(s);
    zero(dp);
    mma_abt<D>(s, ka, qt);    // k q^T
    mma_abt<D>(dp, va, dot);  // v do^T
    const bool masked = needs_mask(r0d, c0, T, causal, window, has_seg);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ki = w0 + frag_row(e), ri = frag_col(n, e);
        float x = s[n][e] * scale;
        if (masked && !live(r0d + ri, c0 + ki, T, causal, window,
                            has_seg ? qseg + st * kTile : nullptr, kseg, ri, ki)) {
          x = kNegInf;
        }
        float p = expf(x - lse_t[ri]);
        if (x <= kNegInf * 0.5f) p = 0.f;
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - delta_t[ri]) * scale;  // ds
      }
    uint32_t fa[4][4];
    to_a(fa, s);                 // p rounded to bf16
    mma_ab<D>(dv_acc, fa, dot);  // dv += p^T do
    to_a(fa, dp);                // ds rounded to bf16
    mma_ab<D>(dk_acc, fa, qt);   // dk += ds^T q
    __syncthreads();             // this stage's readers are done before it refills
  }
  store_acc<D>(dk + kv_off, dk_acc, c0 + w0, T);
  store_acc<D>(dv + kv_off, dv_acc, c0 + w0, T);
}

// dk/dv at head dim 128: two warpgroups over one 64-key tile, warpgroup 0
// summing dv, warpgroup 1 dk, each warp the same 16 keys in both (file
// header). The stream, the masks and the arithmetic are flash_dkv_kernel's;
// k and v stay in shared memory.
template <int D>
__global__ void __launch_bounds__(2 * kThreads, 1) flash_dkv_wide_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int32_t* __restrict__ seg, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int T, int G, int Hkv, int causal, int window,
    int shift, float scale) {
  using Dm = Dims<D>;
  const int n_tiles = (T + kTile - 1) / kTile;
  const int c0 = blockIdx.y * kTile;  // tile 0 sees the most rows under causal
  const int bhkv = blockIdx.x;
  const bool is_dk = threadIdx.x >= kThreads;  // warpgroup 1 (warp-uniform)
  const unsigned tid = threadIdx.x & (kThreads - 1);  // within the warpgroup
  const int w0 = static_cast<int>(tid >> 5) * 16;     // this warp's keys in the tile
  const int c_last = min(c0 + kTile, T) - 1;
  const bool has_seg = seg != nullptr;

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);  // [2] (row, d)
  __nv_bfloat16* dos = qs + 2 * Dm::kElems;                     // [2] (row, d)
  __nv_bfloat16* kr = dos + 2 * Dm::kElems;                     // (key, d)
  __nv_bfloat16* vr = kr + Dm::kElems;                          // (key, d)
  int* qseg = reinterpret_cast<int*>(vr + Dm::kElems);          // [2] (row,)
  int* kseg = qseg + 2 * kTile;                                 // (key,)
  float* lse_s = reinterpret_cast<float*>(kseg + kTile);        // [2] (row,)
  float* delta_s = lse_s + 2 * kTile;                           // [2] (row,)

  const size_t kv_off = static_cast<size_t>(bhkv) * T * D;
  const int32_t* seg_b = has_seg ? seg + static_cast<size_t>(bhkv / Hkv) * T : nullptr;
  const Tiles tiles = query_tiles(c0, c_last, n_tiles, causal, window, shift);
  const int i_lo = tiles.lo;
  const int n_rows = tiles.hi - i_lo + 1;  // live row tiles per query head
  const int n_steps = G * n_rows;
  __nv_bfloat16* out = (is_dk ? dk : dv) + kv_off;
  if (n_rows <= 0) {  // a dead block pair: no query row sees these keys
    store_zeros<D>(out, c0 + w0, T);
    return;
  }

  // step i of the stream, as flash_dkv_kernel's: warpgroup 0 copies q,
  // warpgroup 1 do; lse, delta and the rows' segment ids by threads 0-63,
  // 64-127 and 128-191
  auto load_step = [&](int i, int st) {
    const int bh = bhkv * G + i / n_rows;
    const int r0 = (i_lo + i % n_rows) * kTile;
    const size_t q_off = static_cast<size_t>(bh) * T * D;
    load_tile_async<D>((is_dk ? dos : qs) + st * Dm::kElems, (is_dk ? dout : q) + q_off, r0, T,
                       tid);
    load_vec_async(lse_s + st * kTile, lse + static_cast<size_t>(bh) * T, r0, T, kPadLse, 0);
    load_vec_async(delta_s + st * kTile, delta + static_cast<size_t>(bh) * T, r0, T, 0.f, kTile);
    if (has_seg) load_vec_async(qseg + st * kTile, seg_b, r0, T, -1, 2 * kTile);
  };

  load_tile_async<D>(is_dk ? vr : kr, (is_dk ? v : k) + kv_off, c0, T, tid);
  if (has_seg) load_vec_async(kseg, seg_b, c0, T, -1, 3 * kTile);
  load_step(0, 0);
  cp_async_commit();

  float acc[Dm::kN][4];
#pragma unroll
  for (int n = 0; n < Dm::kN; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  for (int i = 0; i < n_steps; ++i) {
    const int st = i & 1;
    if (i + 1 < n_steps) {
      // the other stage's readers finished at the end of the last step
      load_step(i + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* qt = qs + st * Dm::kElems;
    const __nv_bfloat16* dot = dos + st * Dm::kElems;
    const float* lse_t = lse_s + st * kTile;
    const float* delta_t = delta_s + st * kTile;
    const int r0d = (i_lo + i % n_rows) * kTile + shift;  // the row tile, shifted

    // transposed scores: the warp's 16 keys by the tile's 64 rows
    float s[8][4], dp[8][4];
    zero(s);
    mma_abt_s<D>(s, kr, w0, qt);  // k q^T
    if (is_dk) {
      zero(dp);
      mma_abt_s<D>(dp, vr, w0, dot);  // v do^T
    }
    const bool masked = needs_mask(r0d, c0, T, causal, window, has_seg);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ki = w0 + frag_row(e), ri = frag_col(n, e);
        float x = s[n][e] * scale;
        if (masked && !live(r0d + ri, c0 + ki, T, causal, window,
                            has_seg ? qseg + st * kTile : nullptr, kseg, ri, ki)) {
          x = kNegInf;
        }
        float p = expf(x - lse_t[ri]);
        if (x <= kNegInf * 0.5f) p = 0.f;
        s[n][e] = is_dk ? p * (dp[n][e] - delta_t[ri]) * scale : p;  // ds or p
      }
    uint32_t fa[4][4];
    to_a(fa, s);  // p or ds rounded to bf16
    if (is_dk) {
      mma_ab<D>(acc, fa, qt);  // dk += ds^T q
    } else {
      mma_ab<D>(acc, fa, dot);  // dv += p^T do
    }
    __syncthreads();  // this stage's readers are done before it refills
  }
  store_acc<D>(out, acc, c0 + w0, T);
}

// the tiles of T on the grid's y dimension (at most 65,535)
bool shape_ok(int BH, int BHkv, int T, int H) {
  return BHkv >= 1 && BH % BHkv == 0 && T >= 1 && H >= 1 && BH % H == 0 &&
         (T + kTile - 1) / kTile <= 65535;
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta, *seg;
  void *dq, *dk, *dv;
  int BH, BHkv, T, H, causal, window, shift;
  float scale;
  cudaStream_t stream;
};

template <int D>
int launch_dq(const Args& a) {
  const cudaError_t err = cudaFuncSetAttribute(
      flash_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kDqSmemBytes<D>));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.BH, (a.T + kTile - 1) / kTile);  // every head's heaviest tile first
  flash_dq_kernel<D><<<grid, kThreads, kDqSmemBytes<D>, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), static_cast<const __nv_bfloat16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<const int32_t*>(a.seg), static_cast<__nv_bfloat16*>(a.dq), a.T,
      a.BH / a.BHkv, a.H, a.causal, a.window, a.shift, a.scale);
  return static_cast<int>(cudaGetLastError());
}

// the dk/dv kernel of head dim D
template <int D>
auto dkv_kernel() {
  if constexpr (kWide<D>) {
    return flash_dkv_wide_kernel<D>;
  } else {
    return flash_dkv_kernel<D>;
  }
}

template <int D>
int launch_dkv(const Args& a) {
  const int G = a.BH / a.BHkv;
  const auto kernel = dkv_kernel<D>();
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kDkvSmemBytes<D>));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.BHkv, (a.T + kTile - 1) / kTile);  // every head's heaviest tile first
  kernel<<<grid, kDkvThreads<D>, kDkvSmemBytes<D>, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), static_cast<const __nv_bfloat16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<const int32_t*>(a.seg), static_cast<__nv_bfloat16*>(a.dk),
      static_cast<__nv_bfloat16*>(a.dv), a.T, G, a.H / G, a.causal, a.window, a.shift,
      a.scale);
  return static_cast<int>(cudaGetLastError());
}

// The instantiation for head dim Dh: which 0 dq, 1 dk/dv.
int dispatch(int which, int Dh, const Args& a) {
  switch (Dh) {
    case 8: return which == 0 ? launch_dq<8>(a) : launch_dkv<8>(a);
    case 16: return which == 0 ? launch_dq<16>(a) : launch_dkv<16>(a);
    case 32: return which == 0 ? launch_dq<32>(a) : launch_dkv<32>(a);
    case 64: return which == 0 ? launch_dq<64>(a) : launch_dkv<64>(a);
    case 128: return which == 0 ? launch_dq<128>(a) : launch_dkv<128>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int D>
int resources(int which, int* out) {
  return which == 0 ? kernel_resources(flash_dq_kernel<D>, kDqSmemBytes<D>, out)
                    : kernel_resources(dkv_kernel<D>(), kDkvSmemBytes<D>, out, kDkvThreads<D>);
}

}  // namespace

extern "C" {

// q/do (BH, T, Dh), k/v (BHkv, T, Dh), dq (BH, T, Dh): bf16, contiguous;
// lse/delta (BH, T) f32; seg (B, T) int32 or null, with H = BH / B query
// heads per batch row. Dh is 8, 16, 32, 64 or 128; window <= 0 means none.
// q_offset and kv_offset place q's rows and k/v's keys on the global
// positions the masks compare (both 0 outside the ring's block pairs).
// Returns cudaGetLastError() (or cudaErrorInvalidValue for a refused shape).
int flash_dq_launch(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* delta, const void* seg, void* dq,
                    int BH, int BHkv, int T, int Dh, int H, int causal, int window,
                    int q_offset, int kv_offset, float scale, void* stream) {
  if (!shape_ok(BH, BHkv, T, H)) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, dout, lse, delta, seg, dq, nullptr, nullptr, BH, BHkv, T, H,
               causal, window, q_offset - kv_offset, scale,
               static_cast<cudaStream_t>(stream)};
  return dispatch(0, Dh, a);
}

// As flash_dq_launch; dk/dv (BHkv, T, Dh) bf16, each the sum over the GQA
// group's BH / BHkv query heads.
int flash_dkv_launch(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, const void* seg, void* dk,
                     void* dv, int BH, int BHkv, int T, int Dh, int H, int causal,
                     int window, int q_offset, int kv_offset, float scale, void* stream) {
  if (!shape_ok(BH, BHkv, T, H)) return static_cast<int>(cudaErrorInvalidValue);
  if (H % (BH / BHkv)) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, dout, lse, delta, seg, nullptr, dk, dv, BH, BHkv, T, H,
               causal, window, q_offset - kv_offset, scale,
               static_cast<cudaStream_t>(stream)};
  return dispatch(1, Dh, a);
}

// What each kernel takes on this card at head dim Dh: out[0] registers a
// thread, out[1] local (spilled) bytes a thread, out[2] dynamic shared
// memory a block, out[3] resident blocks an SM. which: 0 dq, 1 dk/dv.
int flash_bwd_resources(int which, int Dh, int* out) {
  switch (Dh) {
    case 8: return resources<8>(which, out);
    case 16: return resources<16>(which, out);
    case 32: return resources<32>(which, out);
    case 64: return resources<64>(which, out);
    case 128: return resources<128>(which, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
