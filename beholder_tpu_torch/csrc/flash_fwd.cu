// Flash attention forward for Hopper (sm_90a), bound through a plain C
// interface (ctypes) by beholder_tpu_torch/ops/flash_attention.py.
//
// Replaces the TPU kernel beholder_tpu/ops/flash_attention.py::_fwd_kernel
// (launched by _flash_fwd_padded, public through flash_attention, and by
// flash_block_attend in the ring's block-pair mode). Each query row attends
// the keys it may see (causal, a sliding window, segment ids), with a
// streaming online softmax, and the kernel writes the output in q's dtype
// and the row's logsumexp in f32 for the backward.
//
// What bounds it: operations. At the training shape (B=4, H=8, Hkv=2,
// T=4096, Dh=64, causal) the score and PV products are 4*B*H*T^2*Dh/2 =
// 68.7 GFLOP, 0.069 ms at the bf16 tensor-core rate, while q, k, v, o and
// lse are ~42 MB, 0.013 ms at 3.35 TB/s.
//
// What the design does about it: both products run on the tensor cores,
// mma.sync.m16n8k16 with bf16 operands and f32 sums (flash_mma.cuh), the
// dq kernel's pieces without the gradient.
// - One warpgroup (4 warps, 128 threads) per (batch*head, 64-row q tile);
//   each warp owns 16 rows. The grid runs every head's longest tile (the
//   last under causal) first.
// - q arrives by cp.async, its A fragments stay in registers for the whole
//   loop, already scaled (below). The live 64-key tiles of k and v stream
//   through bf16 shared memory, rows padded for ldmatrix, double-buffered:
//   cp.async brings tile j+1 while tile j computes. One barrier a tile.
// - s = q k^T lands in f32 registers, 16 x 64 a warp; a row's 64 scores sit
//   in the 4 lanes of a quad, so the online softmax reduces with two
//   xor-shuffles. p, rounded to bf16, becomes the A fragment of PV in
//   registers (to_a): no score or weight touches shared memory.
// - The key loop runs over the live tiles only, from the first tile inside
//   the window (or 0) to the tile holding the diagonal (or the last tile
//   when non-causal); this replaces the TPU kernel's packed triangular and
//   banded grids and their scalar-prefetched tables. The per-element mask
//   runs only on tiles where it can bite. GQA: q head bh reads kv head
//   bh / G. T needs no padding: rows and keys past T are zero-filled and
//   masked in place.
// What bounds it now is not the tensor cores: each warp reads every
// streamed tile through ldmatrix once per product, and the exp and mask
// arithmetic runs on the ordinary f32 units, 32 scores a thread a tile.
// wgmma with TMA loads and 128-row tiles are the next steps.
//
// Head dims 8, 16, 32, 64 and 128, one instantiation each (flash_mma.cuh
// Dims): the score product takes the head dim in 16-wide mma steps, D = 8
// zero-padded to 16 in shared memory by cp.async; PV takes n8 column tiles,
// so the o accumulator grows with D (16 x 4 registers at D = 128).
//
// Ring block-pair mode (the TPU kernel's pallas_call with qoff/kvoff, as
// flash_block_attend launches it): the C entry takes q_offset and kv_offset,
// and the masks run on global positions through the shift delta = q_offset
// - kv_offset (flash_common.cuh). Each block works out its live key tiles
// from the shifted diagonal, so a rectangular, fully live pair runs every
// tile and a dead pair runs none: its rows write o = 0 and lse = -1e30,
// which the ring's online-softmax combine turns into an exact zero.
//
// The arithmetic follows the TPU kernel: q is multiplied by 1/sqrt(Dh) in
// f32 and rounded back to bf16 (in registers, after ldmatrix) before the
// score product; scores are summed in f32, masked to -1e30, and p = exp(s -
// m) is zeroed where the score is masked (a tile can be wholly masked for a
// row under a window or segment ids); the running sum takes the f32 p, the
// PV product the bf16-rounded p; out = acc / max(l, 1e-37) in bf16, lse = m
// + log(l), or -1e30 for a row with no live key (its output is 0).

#include "flash_mma.cuh"

namespace {

using namespace flash;

// two stages of a k tile and a v tile (q passes through the second k slot
// before the loop), then segment ids: the resident rows' and two stages of
// keys'
template <int D>
constexpr size_t kSmemBytes =
    sizeof(__nv_bfloat16) * 4 * Dims<D>::kElems + sizeof(int) * 3 * kTile;
static_assert(kSmemBytes<128> <= 227 * 1024, "shared memory over the per-block limit");

// a bf16 pair times `scale` in f32, rounded back to a bf16 pair (a bf16
// is the top half of its f32)
__device__ __forceinline__ uint32_t scale_pair(uint32_t x, float scale) {
  return pack_bf16(__uint_as_float(x << 16) * scale, __uint_as_float(x & 0xffff0000u) * scale);
}

// at least 3 blocks an SM (2 at head dim 128, whose shared memory allows 3):
// without the hint ptxas settled head dim 8 on 80 registers and a 4-byte spill
template <int D>
constexpr int kMinBlocks = D == 128 ? 2 : 3;

template <int D>
__global__ void __launch_bounds__(kThreads, kMinBlocks<D>) flash_fwd_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int32_t* __restrict__ seg,
    __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int T, int G, int H,
    int causal, int window, int delta, float scale) {
  using Dm = Dims<D>;
  const int n_tiles = (T + kTile - 1) / kTile;
  const int r0 = (n_tiles - 1 - static_cast<int>(blockIdx.y)) * kTile;
  const int bh = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int w0 = (threadIdx.x >> 5) * 16;  // this warp's rows in the tile
  const int r_last = min(r0 + kTile, T) - 1;
  const bool has_seg = seg != nullptr;

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);  // [2] (key, d)
  __nv_bfloat16* vs = ks + 2 * Dm::kElems;                      // [2] (key, d)
  int* qseg = reinterpret_cast<int*>(vs + 2 * Dm::kElems);      // (row,)
  int* kseg = qseg + kTile;                                     // [2] (key,)

  const size_t q_off = static_cast<size_t>(bh) * T * D;
  const size_t kv_off = static_cast<size_t>(bh / G) * T * D;
  const int32_t* seg_b = has_seg ? seg + static_cast<size_t>(bh / H) * T : nullptr;
  // an empty range (j_lo > j_hi): a dead block pair, whose rows keep l = 0
  const Tiles tiles = key_tiles(r0, r_last, n_tiles, causal, window, delta);
  const int j_lo = tiles.lo, j_hi = tiles.hi;
  const int r0d = r0 + delta;  // the tile's first row, shifted

  // q passes through the second stage's k slot; the first key tile goes to
  // the first stage
  load_tile_async<D>(ks + Dm::kElems, q + q_off, r0, T);
  load_tile_async<D>(ks, k + kv_off, j_lo * kTile, T);
  load_tile_async<D>(vs, v + kv_off, j_lo * kTile, T);
  if (has_seg) {
    load_vec_async(qseg, seg_b, r0, T, -1, 0);
    load_vec_async(kseg, seg_b, j_lo * kTile, T, -1, kTile);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qa[Dm::kSteps][4];
  load_a<D>(qa, ks + Dm::kElems, w0);
  // the softmax scale folded into q: an f32 product rounded back to bf16
#pragma unroll
  for (int kk = 0; kk < Dm::kSteps; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) qa[kk][i] = scale_pair(qa[kk][i], scale);

  float acc[Dm::kN][4];
#pragma unroll
  for (int n = 0; n < Dm::kN; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = kNegInf, l0 = 0.f, m1 = kNegInf, l1 = 0.f;  // rows g and g + 8
  for (int j = j_lo; j <= j_hi; ++j) {
    const int st = (j - j_lo) & 1;
    cp_async_wait<0>();
    // tile j is in; every warp is done with tile j - 1 (and with q's slot)
    __syncthreads();
    if (j < j_hi) {
      const int nx = st ^ 1;
      load_tile_async<D>(ks + nx * Dm::kElems, k + kv_off, (j + 1) * kTile, T);
      load_tile_async<D>(vs + nx * Dm::kElems, v + kv_off, (j + 1) * kTile, T);
      if (has_seg) load_vec_async(kseg + nx * kTile, seg_b, (j + 1) * kTile, T, -1, 0);
      cp_async_commit();
    }
    const int c0 = j * kTile;

    float s[8][4];
    zero(s);
    mma_abt<D>(s, qa, ks + st * Dm::kElems);  // (q * scale) k^T
    if (needs_mask(r0d, c0, T, causal, window, has_seg)) {
      const int* kseg_t = kseg + st * kTile;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ri = w0 + frag_row(e), ci = frag_col(n, e);
          if (!live(r0d + ri, c0 + ci, T, causal, window, has_seg ? qseg : nullptr, kseg_t,
                    ri, ci)) {
            s[n][e] = kNegInf;
          }
        }
    }
    online_softmax(s, acc, 0, m0, l0);
    online_softmax(s, acc, 1, m1, l1);
    uint32_t pa[4][4];
    to_a(pa, s);                                 // p rounded to bf16
    mma_ab<D>(acc, pa, vs + st * Dm::kElems);    // acc += p v
  }

  normalize(acc, 0, l0);
  normalize(acc, 1, l1);
  const int row = r0 + w0 + (lane >> 2);
  float* lse_bh = lse + static_cast<size_t>(bh) * T;
  if ((lane & 3) == 0) {
    if (row < T) lse_bh[row] = l0 > 0.f ? m0 + logf(fmaxf(l0, 1e-37f)) : kNegInf;
    if (row + 8 < T) lse_bh[row + 8] = l1 > 0.f ? m1 + logf(fmaxf(l1, 1e-37f)) : kNegInf;
  }
  store_acc<D>(out + q_off, acc, r0 + w0, T);
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* seg, void* out,
           void* lse, int BH, int BHkv, int T, int H, int causal, int window, int delta,
           float scale, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes<D>));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(BH, (T + kTile - 1) / kTile);  // every head's longest tile first
  flash_fwd_kernel<D><<<grid, kThreads, kSmemBytes<D>, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int32_t*>(seg),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), T, BH / BHkv, H,
      causal, window, delta, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int resources(int* out) {
  return kernel_resources(flash_fwd_kernel<D>, kSmemBytes<D>, out);
}

}  // namespace

extern "C" {

// q (BH, T, Dh), k/v (BHkv, T, Dh), out (BH, T, Dh): bf16, contiguous,
// 16-byte aligned; lse (BH, T) f32; seg (B, T) int32 or null, with H = BH /
// B query heads per batch row. Dh is 8, 16, 32, 64 or 128; window <= 0
// means none. q_offset and kv_offset place q's rows and k/v's keys on the
// global positions the causal and window masks compare (both 0 outside the
// ring's block pairs). Returns cudaGetLastError() (or cudaErrorInvalidValue
// for a refused shape).
int flash_fwd_launch(const void* q, const void* k, const void* v, const void* seg,
                     void* out, void* lse, int BH, int BHkv, int T, int Dh, int H,
                     int causal, int window, int q_offset, int kv_offset, float scale,
                     void* stream) {
  // the tiles of T on the grid's y dimension (at most 65,535)
  if (BHkv < 1 || BH % BHkv || T < 1 || H < 1 || BH % H ||
      (T + kTile - 1) / kTile > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int delta = q_offset - kv_offset;
  const auto st = static_cast<cudaStream_t>(stream);
#define FLASH_FWD_ARGS q, k, v, seg, out, lse, BH, BHkv, T, H, causal, window, delta, scale, st
  switch (Dh) {
    case 8: return launch<8>(FLASH_FWD_ARGS);
    case 16: return launch<16>(FLASH_FWD_ARGS);
    case 32: return launch<32>(FLASH_FWD_ARGS);
    case 64: return launch<64>(FLASH_FWD_ARGS);
    case 128: return launch<128>(FLASH_FWD_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FLASH_FWD_ARGS
}

// What the kernel takes on this card at head dim Dh: out[0] registers a
// thread, out[1] local (spilled) bytes a thread, out[2] dynamic shared
// memory a block, out[3] resident blocks an SM.
int flash_fwd_resources(int Dh, int* out) {
  switch (Dh) {
    case 8: return resources<8>(out);
    case 16: return resources<16>(out);
    case 32: return resources<32>(out);
    case 64: return resources<64>(out);
    case 128: return resources<128>(out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
