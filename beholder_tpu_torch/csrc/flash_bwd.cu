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
// (q, k, v, o, do, lse, delta, and the gradients) are below 0.02 ms. The
// products here are f32 FMA loops over shared memory (flash_common.cuh), so
// the f32 rate (67 TFLOP/s) is their own ceiling; mma.sync and then
// wgmma/TMA are the next steps.
//
// What the design does about it:
// - dq: one block per (batch*head, 64-row q tile); q, do, lse and delta stay
//   resident while the live 64-key tiles stream (the forward's band).
// - dk/dv: one block per (batch*kv head, 64-key tile); k and v stay resident
//   while the live q tiles of each of the GQA group's G query heads stream,
//   and dk/dv accumulate over the whole group in f32 registers. The TPU
//   version writes per-q-head partials in k's dtype and sums them in XLA;
//   this kernel needs neither that transient nor atomics, and rounds once.
// - Tiles are live only: the causal diagonal and the window bound each loop,
//   and the per-element mask runs only where it can bite.
//
// The arithmetic follows the TPU kernels: s = (q k^T) * scale in f32 with q
// unscaled; masked to -1e30; p = exp(s - lse), zeroed where the score is
// masked (a row with no live key carries lse = -1e30); a query row past T
// carries lse = +1e30 so its p is exactly 0; ds = p * (dp - delta) * scale;
// ds is rounded to bf16 before the dq and dk products, p before the dv
// product; dq, dk and dv are summed in f32 and written in bf16.
// delta = rowsum(do * o) in f32 comes in precomputed (plain torch, as the
// reference computes it in XLA).

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr size_t kDqSmemBytes = sizeof(float) * 6 * kTileFloats + sizeof(int) * 2 * kTile;
constexpr size_t kDkvSmemBytes =
    sizeof(float) * (8 * kTileFloats + 2 * kTile) + sizeof(int) * 2 * kTile;
static_assert(kDqSmemBytes <= 227 * 1024, "shared memory over the per-block limit");
static_assert(kDkvSmemBytes <= 227 * 1024, "shared memory over the per-block limit");

__global__ void __launch_bounds__(kThreads) flash_dq_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int32_t* __restrict__ seg, __nv_bfloat16* __restrict__ dq, int T, int G,
    int H, int causal, int window, float scale) {
  const int n_tiles = (T + kTile - 1) / kTile;
  const int r0 = (n_tiles - 1 - static_cast<int>(blockIdx.x)) * kTile;
  const int bh = blockIdx.y;
  const int rg = threadIdx.x >> 4;
  const int cg = threadIdx.x & 15;
  const int r_last = min(r0 + kTile, T) - 1;

  extern __shared__ float smem[];
  float* qT = smem;                  // (d, row)
  float* doT = qT + kTileFloats;     // (d, row)
  float* kT = doT + kTileFloats;     // (d, key)
  float* vT = kT + kTileFloats;      // (d, key)
  float* kR = vT + kTileFloats;      // (key, d)
  float* dsT = kR + kTileFloats;     // (key, row): ds rounded to bf16
  int* qseg = reinterpret_cast<int*>(dsT + kTileFloats);
  int* kseg = qseg + kTile;

  const size_t q_off = static_cast<size_t>(bh) * T * kDh;
  const size_t kv_off = static_cast<size_t>(bh / G) * T * kDh;
  const int b = bh / H;
  stage(qT, nullptr, q + q_off, r0, T, 0.f);
  stage(doT, nullptr, dout + q_off, r0, T, 0.f);
  if (seg != nullptr) stage_seg(qseg, seg, b, r0, T);
  float lse_r[8], delta_r[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = r0 + rg * 8 + i;
    lse_r[i] = row < T ? lse[static_cast<size_t>(bh) * T + row] : kPadLse;
    delta_r[i] = row < T ? delta[static_cast<size_t>(bh) * T + row] : 0.f;
  }

  float acc[8][4];
  zero(acc);
  const int j_lo = window > 0 ? max(0, r0 - window + 1) / kTile : 0;
  const int j_hi = causal ? r_last / kTile : n_tiles - 1;
  for (int j = j_lo; j <= j_hi; ++j) {
    const int c0 = j * kTile;
    __syncthreads();
    stage(kT, kR, k + kv_off, c0, T, 0.f);
    stage(vT, nullptr, v + kv_off, c0, T, 0.f);
    if (seg != nullptr) stage_seg(kseg, seg, b, c0, T);
    __syncthreads();

    float s[8][4], dp[8][4];
    zero(s);
    zero(dp);
    outer_acc(s, qT, kT, rg, cg);
    outer_acc(dp, doT, vT, rg, cg);
    const bool masked = needs_mask(r0, c0, T, causal, window, seg != nullptr);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = s[i][c] * scale;
        if (masked && !live(r0 + rg * 8 + i, c0 + cg * 4 + c, T, causal, window,
                            seg != nullptr ? qseg : nullptr, kseg, rg * 8 + i, cg * 4 + c)) {
          x = kNegInf;
        }
        float p = expf(x - lse_r[i]);
        if (x <= kNegInf * 0.5f) p = 0.f;
        s[i][c] = p * (dp[i][c] - delta_r[i]) * scale;  // ds
      }
    store_t_bf16(dsT, s, rg, cg);
    __syncthreads();
    outer_acc(acc, dsT, kR, rg, cg);
  }
  write_rows(dq + q_off, acc, r0, T, rg, cg);
}

__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int32_t* __restrict__ seg, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int T, int G, int Hkv, int causal, int window,
    float scale) {
  const int n_tiles = (T + kTile - 1) / kTile;
  const int c0 = blockIdx.x * kTile;  // tile 0 sees the most rows under causal
  const int bhkv = blockIdx.y;
  const int rg = threadIdx.x >> 4;    // this thread's keys rg*8 + i
  const int cg = threadIdx.x & 15;    // its rows (scores) and dims (dk, dv) cg*4 + c
  const int c_last = min(c0 + kTile, T) - 1;

  extern __shared__ float smem[];
  float* kT = smem;                  // (d, key), resident
  float* vT = kT + kTileFloats;      // (d, key), resident
  float* qT = vT + kTileFloats;      // (d, row)
  float* qR = qT + kTileFloats;      // (row, d)
  float* doT = qR + kTileFloats;     // (d, row)
  float* doR = doT + kTileFloats;    // (row, d)
  float* pR = doR + kTileFloats;     // (row, key): p rounded to bf16
  float* dsR = pR + kTileFloats;     // (row, key): ds rounded to bf16
  float* lse_s = dsR + kTileFloats;  // (row,)
  float* delta_s = lse_s + kTile;    // (row,)
  int* qseg = reinterpret_cast<int*>(delta_s + kTile);
  int* kseg = qseg + kTile;

  const size_t kv_off = static_cast<size_t>(bhkv) * T * kDh;
  const int b = bhkv / Hkv;
  stage(kT, nullptr, k + kv_off, c0, T, 0.f);
  stage(vT, nullptr, v + kv_off, c0, T, 0.f);
  if (seg != nullptr) stage_seg(kseg, seg, b, c0, T);

  float dk_acc[8][4], dv_acc[8][4];
  zero(dk_acc);
  zero(dv_acc);
  const int i_lo = causal ? c0 / kTile : 0;
  const int i_hi = window > 0 ? min(n_tiles - 1, (c_last + window - 1) / kTile) : n_tiles - 1;
  for (int g = 0; g < G; ++g) {
    const int bh = bhkv * G + g;
    const size_t q_off = static_cast<size_t>(bh) * T * kDh;
    for (int it = i_lo; it <= i_hi; ++it) {
      const int r0 = it * kTile;
      __syncthreads();
      stage(qT, qR, q + q_off, r0, T, 0.f);
      stage(doT, doR, dout + q_off, r0, T, 0.f);
      for (int r = threadIdx.x; r < kTile; r += kThreads) {
        const int row = r0 + r;
        lse_s[r] = row < T ? lse[static_cast<size_t>(bh) * T + row] : kPadLse;
        delta_s[r] = row < T ? delta[static_cast<size_t>(bh) * T + row] : 0.f;
      }
      if (seg != nullptr) stage_seg(qseg, seg, b, r0, T);
      __syncthreads();

      // transposed scores: keys rg*8 + i by rows cg*4 + c
      float s[8][4], dp[8][4];
      zero(s);
      zero(dp);
      outer_acc(s, kT, qT, rg, cg);
      outer_acc(dp, vT, doT, rg, cg);
      const bool masked = needs_mask(r0, c0, T, causal, window, seg != nullptr);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int ri = cg * 4 + c;
          float x = s[i][c] * scale;
          if (masked && !live(r0 + ri, c0 + rg * 8 + i, T, causal, window,
                              seg != nullptr ? qseg : nullptr, kseg, ri, rg * 8 + i)) {
            x = kNegInf;
          }
          float p = expf(x - lse_s[ri]);
          if (x <= kNegInf * 0.5f) p = 0.f;
          s[i][c] = p;
          dp[i][c] = p * (dp[i][c] - delta_s[ri]) * scale;  // ds
        }
      store_t_bf16(pR, s, rg, cg);
      store_t_bf16(dsR, dp, rg, cg);
      __syncthreads();
      outer_acc(dv_acc, pR, doR, rg, cg);
      outer_acc(dk_acc, dsR, qR, rg, cg);
    }
  }
  write_rows(dk + kv_off, dk_acc, c0, T, rg, cg);
  write_rows(dv + kv_off, dv_acc, c0, T, rg, cg);
}

}  // namespace

extern "C" {

// q/do (BH, T, Dh), k/v (BHkv, T, Dh), dq (BH, T, Dh): bf16, contiguous;
// lse/delta (BH, T) f32; seg (B, T) int32 or null, with H = BH / B query
// heads per batch row. Dh must be 64; window <= 0 means none.
// Returns cudaGetLastError() (or cudaErrorInvalidValue for a refused shape).
int flash_dq_launch(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* delta, const void* seg, void* dq,
                    int BH, int BHkv, int T, int Dh, int H, int causal, int window,
                    float scale, void* stream) {
  if (Dh != kDh || BHkv < 1 || BH % BHkv || T < 1 || H < 1 || BH % H) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaFuncSetAttribute(
      flash_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kDqSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + kTile - 1) / kTile, BH);
  flash_dq_kernel<<<grid, kThreads, kDqSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int32_t*>(seg), static_cast<__nv_bfloat16*>(dq), T, BH / BHkv,
      H, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

// As flash_dq_launch; dk/dv (BHkv, T, Dh) bf16, each the sum over the GQA
// group's BH / BHkv query heads.
int flash_dkv_launch(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, const void* seg, void* dk,
                     void* dv, int BH, int BHkv, int T, int Dh, int H, int causal,
                     int window, float scale, void* stream) {
  if (Dh != kDh || BHkv < 1 || BH % BHkv || T < 1 || H < 1 || BH % H) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int G = BH / BHkv;
  if (H % G) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kDkvSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + kTile - 1) / kTile, BHkv);
  flash_dkv_kernel<<<grid, kThreads, kDkvSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int32_t*>(seg), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), T, G, H / G, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
