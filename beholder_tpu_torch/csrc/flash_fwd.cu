// Flash attention forward for Hopper (sm_90a), bound through a plain C
// interface (ctypes) by beholder_tpu_torch/ops/flash_attention.py.
//
// Replaces the TPU kernel beholder_tpu/ops/flash_attention.py::_fwd_kernel
// (launched by _flash_fwd_padded, public through flash_attention). Each
// query row attends the keys it may see (causal, a sliding window, segment
// ids), with a streaming online softmax, and the kernel writes the output in
// q's dtype and the row's logsumexp in f32 for the backward.
//
// What bounds it: operations. At the training shape (B=4, H=8, Hkv=2,
// T=4096, Dh=64, causal) the score and PV products are 4*B*H*T^2*Dh/2 =
// 68.7 GFLOP, 0.069 ms at the bf16 tensor-core rate, while q, k, v, o and
// lse are ~42 MB, 0.013 ms at 3.35 TB/s. This kernel runs the products as
// f32 FMA loops over shared memory (see flash_common.cuh), so the f32 rate
// (67 TFLOP/s, about 1 ms here) is its own ceiling; mma.sync and then
// wgmma/TMA products are the next steps.
//
// What the design does about it: one block per (batch*head, 64-row q tile).
// Inside the block a loop runs over the live 64-key tiles only, from the
// first tile inside the window (or 0) to the tile holding the diagonal (or
// the last tile when non-causal); this loop replaces the TPU kernel's packed
// triangular and banded grids and their scalar-prefetched tables. Blocks are
// numbered longest-first (the last q tile sees the most keys). The per-
// element mask runs only on tiles where it can bite. GQA: q head bh reads kv
// head bh / G. T needs no padding: rows and keys past T are masked in place.
//
// Head dims 8, 16, 32 and 64, one instantiation each: the score product
// sums over the D real head dims; the PV product runs the 64 columns of the
// D = 64 layout and writes the first D (the rest of the v tile is zeros).
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
// f32 and rounded back to bf16 before the score product; scores are summed
// in f32, masked to -1e30, and p = exp(s - m) is zeroed where the score is
// masked (a tile can be wholly masked for a row under a window or segment
// ids); the running sum takes the f32 p, the PV product the bf16-rounded p;
// out = acc / max(l, 1e-37) in bf16, lse = m + log(l), or -1e30 for a row
// with no live key (its output is 0).

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr size_t kSmemBytes = sizeof(float) * 4 * kTileFloats + sizeof(int) * 2 * kTile;
static_assert(kSmemBytes <= 227 * 1024, "shared memory over the per-block limit");

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int32_t* __restrict__ seg,
    __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int T, int G, int H,
    int causal, int window, int delta, float scale) {
  const int n_tiles = (T + kTile - 1) / kTile;
  const int r0 = (n_tiles - 1 - static_cast<int>(blockIdx.x)) * kTile;
  const int bh = blockIdx.y;
  const int rg = threadIdx.x >> 4;
  const int cg = threadIdx.x & 15;
  const int r_last = min(r0 + kTile, T) - 1;

  extern __shared__ float smem[];
  float* qT = smem;                  // (d, row): q * scale, rounded to bf16
  float* kT = qT + kTileFloats;      // (d, key)
  float* vR = kT + kTileFloats;      // (key, d)
  float* pT = vR + kTileFloats;      // (key, row): p rounded to bf16
  int* qseg = reinterpret_cast<int*>(pT + kTileFloats);
  int* kseg = qseg + kTile;

  const size_t q_off = static_cast<size_t>(bh) * T * D;
  const size_t kv_off = static_cast<size_t>(bh / G) * T * D;
  const int b = bh / H;
  if (D < kMaxDh) {
    // the v tile's head dims past D stay zero: PV runs all 64 columns
    for (int i = threadIdx.x; i < kTileFloats; i += kThreads) vR[i] = 0.f;
  }
  stage<D>(qT, nullptr, q + q_off, r0, T, scale);
  if (seg != nullptr) stage_seg(qseg, seg, b, r0, T);

  float m[8], l[8], acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  zero(acc);

  // an empty range: a dead pair, whose rows keep l = 0
  const Tiles tiles = key_tiles(r0, r_last, n_tiles, causal, window, delta);
  const int r0d = r0 + delta;  // the tile's first row, shifted
  for (int j = tiles.lo; j <= tiles.hi; ++j) {
    const int c0 = j * kTile;
    __syncthreads();  // the previous tile's readers are done
    stage<D>(kT, nullptr, k + kv_off, c0, T, 0.f);
    stage<D>(nullptr, vR, v + kv_off, c0, T, 0.f);
    if (seg != nullptr) stage_seg(kseg, seg, b, c0, T);
    __syncthreads();

    float s[8][4];
    zero(s);
    outer_acc<D>(s, qT, kT, rg, cg);
    if (needs_mask(r0d, c0, T, causal, window, seg != nullptr)) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (!live(r0d + rg * 8 + i, c0 + cg * 4 + c, T, causal, window,
                    seg != nullptr ? qseg : nullptr, kseg, rg * 8 + i, cg * 4 + c)) {
            s[i][c] = kNegInf;
          }
        }
    }
    // online softmax: a row's 64 scores sit in the 16 threads of a half-warp
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float p = expf(s[i][c] - m_new);
        if (s[i][c] <= kNegInf * 0.5f) p = 0.f;
        s[i][c] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] *= alpha;
    }
    store_t_bf16(pT, s, rg, cg);
    __syncthreads();
    outer_acc<kTile>(acc, pT, vR, rg, cg);
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float denom = fmaxf(l[i], 1e-37f);
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] /= denom;
    const int row = r0 + rg * 8 + i;
    if (cg == 0 && row < T) {
      lse[static_cast<size_t>(bh) * T + row] = l[i] > 0.f ? m[i] + logf(denom) : kNegInf;
    }
  }
  write_rows<D>(out + q_off, acc, r0, T, rg, cg);
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* seg, void* out,
           void* lse, int BH, int BHkv, int T, int H, int causal, int window, int delta,
           float scale, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + kTile - 1) / kTile, BH);
  flash_fwd_kernel<D><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int32_t*>(seg),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), T, BH / BHkv, H,
      causal, window, delta, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q (BH, T, Dh), k/v (BHkv, T, Dh), out (BH, T, Dh): bf16, contiguous;
// lse (BH, T) f32; seg (B, T) int32 or null, with H = BH / B query heads
// per batch row. Dh is 8, 16, 32 or 64; window <= 0 means none. q_offset
// and kv_offset place q's rows and k/v's keys on the global positions the
// causal and window masks compare (both 0 outside the ring's block pairs).
// Returns cudaGetLastError() (or cudaErrorInvalidValue for a refused shape).
int flash_fwd_launch(const void* q, const void* k, const void* v, const void* seg,
                     void* out, void* lse, int BH, int BHkv, int T, int Dh, int H,
                     int causal, int window, int q_offset, int kv_offset, float scale,
                     void* stream) {
  if (BHkv < 1 || BH % BHkv || T < 1 || H < 1 || BH % H) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int delta = q_offset - kv_offset;
  const auto st = static_cast<cudaStream_t>(stream);
  switch (Dh) {
    case 8: return launch<8>(q, k, v, seg, out, lse, BH, BHkv, T, H, causal, window, delta, scale, st);
    case 16: return launch<16>(q, k, v, seg, out, lse, BH, BHkv, T, H, causal, window, delta, scale, st);
    case 32: return launch<32>(q, k, v, seg, out, lse, BH, BHkv, T, H, causal, window, delta, scale, st);
    case 64: return launch<64>(q, k, v, seg, out, lse, BH, BHkv, T, H, causal, window, delta, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
