// Flash attention in f32 for Hopper (sm_90a): the forward, the dq kernel and
// the dk/dv kernel for f32 inputs, bound through a plain C interface (ctypes)
// by beholder_tpu_torch/ops/flash_attention.py beside the bf16 kernels of
// flash_fwd.cu and flash_bwd.cu.
//
// Replaces the TPU kernels beholder_tpu/ops/flash_attention.py::_fwd_kernel,
// ::_dq_kernel and ::_dkv_kernel where they run on f32 inputs: the reference
// runs every product in the input dtype, so an f32 call keeps f32 products
// with f32 sums (its own tests are f32). The bf16 kernels' mma.sync takes
// bf16 operands, and TF32 keeps a 10-bit mantissa, which cannot meet the
// reference's f32 bands (forward rtol 1e-4, atol 1e-5). So every product
// here is an f32 FMA on the ordinary units.
//
// What bounds them: operations. At the training shape (B=4, H=8, Hkv=2,
// T=4096, Dh=64, causal) the forward's two products are 68.7 GFLOP, 1.03 ms
// at the card's 67 TFLOP/s of f32 outside the tensor cores, against ~84 MB
// of f32 inputs and outputs (0.025 ms at 3.35 TB/s); dq runs three
// products (1.5 ms), dk/dv four (2.1 ms).
//
// The design, the same for the three kernels:
// - 256 threads (16 x 16) a block over a 64 x 64 tile of scores: thread
//   (ty, tx) owns rows 4 ty .. 4 ty + 3 and keys 4 tx .. 4 tx + 3, 16
//   scores in registers. The operands of the score products sit in shared
//   memory d-major (a (Dh, 64) tile, rows padded to 68 floats), so each
//   step of the head dim is one float4 of rows and one of keys for 16 FMAs.
// - A row's 64 scores sit in the 16 threads of a half warp: the online
//   softmax (forward) reduces with four xor-shuffles. p (forward) or ds
//   (dq) goes through a shared (64, 68) tile to the product that sums over
//   the keys, where thread (ty, tx) owns its 4 rows at head dims tx, tx +
//   16, ...: its rows' softmax state stays in its registers.
// - The forward and dq: one block per (batch*head, 64-row q tile), every
//   head's longest tile (the last under causal) first; q (and do) stay in
//   shared memory, the live 64-key tiles of k and v stream through.
// - dk/dv: one block per (batch*kv head, 64-key tile), key tile 0 (the most
//   rows under causal) first; k and v stay, the live q tiles of each of
//   the GQA group's query heads stream through with do, lse and delta; dk
//   and dv are summed over the group in f32 registers, query head by query
//   head, without atomics: two launches give the same bits.
// - The live tiles, masks and ring block-pair offsets are the bf16
//   kernels' (flash_common.cuh): key_tiles / query_tiles bound each loop
//   from the shifted diagonal and the window, the per-element mask runs
//   only where it can bite, a dead block pair writes o = 0 and lse = -1e30
//   (zero gradients in the backward).
// Head dims 8, 16, 32, 64 and 128, one instantiation each; the wrapper runs
// any head dim up to 128 at the next of them, its q, k, v and do zero-padded
// and its scale that of the true head dim.
// What is left for later: 3xTF32 on the tensor cores (split each operand
// into a TF32 high part and a residual), which keeps f32 accuracy at about
// three times the TF32 rate.
//
// The arithmetic is the TPU kernels' for f32 inputs: the forward multiplies
// q by the scale in f32 before the score product; the backward scales the
// f32 score instead; masked scores are -1e30 and p = exp(s - m) (forward)
// or exp(s - lse) (backward) is zeroed there; ds = p * (dp - delta) *
// scale; a query row past T carries lse = +1e30, so its p is exactly 0;
// out = acc / max(l, 1e-37), lse = m + log(l), or -1e30 for a row with no
// live key.

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int kF32Threads = 256;   // 16 x 16
constexpr int kLdT = kTile + 4;    // a d-major tile's row: 64 floats + 4 (float4 aligned)

// output columns a thread owns: tx, tx + 16, ... below D
template <int D>
constexpr int kNC = D < 16 ? 1 : D / 16;

template <int D>
constexpr size_t kFwdSmem = sizeof(float) * (2 * D * kLdT + kTile * D + kTile * kLdT) +
                            sizeof(int) * 2 * kTile;
template <int D>
constexpr size_t kDqSmem = sizeof(float) * (4 * D * kLdT + kTile * kLdT + 2 * kTile) +
                           sizeof(int) * 2 * kTile;
template <int D>
constexpr size_t kDkvSmem = sizeof(float) * (4 * D * kLdT + 2 * kTile * kLdT + 2 * kTile) +
                            sizeof(int) * 2 * kTile;
static_assert(kDkvSmem<128> <= 227 * 1024 && kDqSmem<128> <= 227 * 1024 &&
                  kFwdSmem<128> <= 227 * 1024,
              "shared memory over the per-block limit");

// Rows [r0, r0 + kTile) of a (T, D) f32 matrix, each value times `mul`, into
// a d-major tile dst[d * kLdT + r]; rows at or past T read as zeros.
template <int D>
__device__ __forceinline__ void load_t(float* dst, const float* __restrict__ src, int r0,
                                       int T, float mul) {
  constexpr int kQ = D / 4;
  for (int i = threadIdx.x; i < kTile * kQ; i += kF32Threads) {
    const int r = i % kTile;
    const int d = (i / kTile) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < T) x = *reinterpret_cast<const float4*>(src + static_cast<size_t>(r0 + r) * D + d);
    dst[d * kLdT + r] = x.x * mul;
    dst[(d + 1) * kLdT + r] = x.y * mul;
    dst[(d + 2) * kLdT + r] = x.z * mul;
    dst[(d + 3) * kLdT + r] = x.w * mul;
  }
}

// The same rows kept row-major, dst[r * D + d].
template <int D>
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src, int r0,
                                          int T) {
  constexpr int kQ = D / 4;
  for (int i = threadIdx.x; i < kTile * kQ; i += kF32Threads) {
    const int r = i / kQ;
    const int d = (i % kQ) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < T) x = *reinterpret_cast<const float4*>(src + static_cast<size_t>(r0 + r) * D + d);
    *reinterpret_cast<float4*>(dst + r * D + d) = x;
  }
}

// kTile values src[r0 + r] into dst[r]; a row at or past T gets `fill`.
template <typename V>
__device__ __forceinline__ void load_vec(V* dst, const V* __restrict__ src, int r0, int T,
                                         V fill) {
  for (int r = threadIdx.x; r < kTile; r += kF32Threads) dst[r] = r0 + r < T ? src[r0 + r] : fill;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc[i][j] += a[i] b[j] for the 4 x 4 outer product of two float4s
__device__ __forceinline__ void outer(float (&acc)[4][4], float4 a, float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc[i][0] = fmaf(av[i], b.x, acc[i][0]);
    acc[i][1] = fmaf(av[i], b.y, acc[i][1]);
    acc[i][2] = fmaf(av[i], b.z, acc[i][2]);
    acc[i][3] = fmaf(av[i], b.w, acc[i][3]);
  }
}

// acc[i] += p[i] . x: four terms of a sum over keys (or rows), in order
__device__ __forceinline__ float dot4(float acc, float4 p, float4 x) {
  acc = fmaf(p.x, x.x, acc);
  acc = fmaf(p.y, x.y, acc);
  acc = fmaf(p.z, x.z, acc);
  return fmaf(p.w, x.w, acc);
}

// a sum over the 16 threads of a half warp
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <int D>
__global__ void __launch_bounds__(kF32Threads, 1) flash_f32_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const int32_t* __restrict__ seg, float* __restrict__ out, float* __restrict__ lse, int T,
    int G, int H, int causal, int window, int delta, float scale) {
  const int n_tiles = (T + kTile - 1) / kTile;
  const int r0 = (n_tiles - 1 - static_cast<int>(blockIdx.y)) * kTile;
  const int bh = blockIdx.x;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int r_last = min(r0 + kTile, T) - 1;
  const bool has_seg = seg != nullptr;

  extern __shared__ __align__(16) float sm[];
  float* qT = sm;                   // (D, kLdT), times scale
  float* kT = qT + D * kLdT;        // (D, kLdT)
  float* vs = kT + D * kLdT;        // (key, D)
  float* ps = vs + kTile * D;       // (row, kLdT)
  int* qseg = reinterpret_cast<int*>(ps + kTile * kLdT);
  int* kseg = qseg + kTile;

  const size_t q_off = static_cast<size_t>(bh) * T * D;
  const size_t kv_off = static_cast<size_t>(bh / G) * T * D;
  const int32_t* seg_b = has_seg ? seg + static_cast<size_t>(bh / H) * T : nullptr;
  const Tiles tiles = key_tiles(r0, r_last, n_tiles, causal, window, delta);
  const int r0d = r0 + delta;

  // the softmax scale folded into q: an f32 product
  load_t<D>(qT, q + q_off, r0, T, scale);
  if (has_seg) load_vec(qseg, seg_b, r0, T, -1);

  float acc[4][kNC<D>];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kNC<D>; ++j) acc[i][j] = 0.f;
  }
  for (int jt = tiles.lo; jt <= tiles.hi; ++jt) {
    const int c0 = jt * kTile;
    __syncthreads();  // every thread is done with the last tile (and q's load is in)
    load_t<D>(kT, k + kv_off, c0, T, 1.f);
    load_rows<D>(vs, v + kv_off, c0, T);
    if (has_seg) load_vec(kseg, seg_b, c0, T, -1);
    __syncthreads();

    float s[4][4] = {};
#pragma unroll 8
    for (int d = 0; d < D; ++d) outer(s, ld4(qT + d * kLdT + 4 * ty), ld4(kT + d * kLdT + 4 * tx));
    if (needs_mask(r0d, c0, T, causal, window, has_seg)) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int ri = 4 * ty + i, ci = 4 * tx + j;
          if (!live(r0d + ri, c0 + ci, T, causal, window, has_seg ? qseg : nullptr, kseg, ri,
                    ci)) {
            s[i][j] = kNegInf;
          }
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float mx = half_warp_max(fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3])));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float x = s[i][j];
        float p = expf(x - m_new);
        if (x <= kNegInf * 0.5f) p = 0.f;
        s[i][j] = p;
        sum += p;
      }
      sum = half_warp_sum(sum);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kNC<D>; ++j) acc[i][j] *= alpha;
      *reinterpret_cast<float4*>(ps + (4 * ty + i) * kLdT + 4 * tx) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    }
    __syncthreads();
    // acc += p v over the tile's 64 keys, four at a time
#pragma unroll 2
    for (int c = 0; c < kTile; c += 4) {
      float4 p4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p4[i] = ld4(ps + (4 * ty + i) * kLdT + c);
#pragma unroll
      for (int j = 0; j < kNC<D>; ++j) {
        const int col = tx + 16 * j;
        if (col >= D) continue;
        const float4 v4 = make_float4(vs[c * D + col], vs[(c + 1) * D + col],
                                      vs[(c + 2) * D + col], vs[(c + 3) * D + col]);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = dot4(acc[i][j], p4[i], v4);
      }
    }
  }

  float* lse_bh = lse + static_cast<size_t>(bh) * T;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + 4 * ty + i;
    if (row >= T) continue;
    const float denom = fmaxf(l[i], 1e-37f);
#pragma unroll
    for (int j = 0; j < kNC<D>; ++j) {
      const int col = tx + 16 * j;
      if (col < D) out[q_off + static_cast<size_t>(row) * D + col] = acc[i][j] / denom;
    }
    if (tx == 0) lse_bh[row] = l[i] > 0.f ? m[i] + logf(fmaxf(l[i], 1e-37f)) : kNegInf;
  }
}

// The backward's p and ds of a thread's 4 x 4 scores: s (unscaled) and dp in,
// p or ds out in place. rows/keys: the thread's shifted rows' and keys' local
// indices into the tiles (row i of s is rows[i]; element (i, j) pairs rows[i]
// with keys[j]); `masked` says whether the per-element mask can bite.
template <bool kKeysMajor>
__device__ __forceinline__ void probabilities(float (&s)[4][4], float (&dp)[4][4],
                                              const float* lse_s, const float* dl_s,
                                              const int* qseg, const int* kseg, int base_i,
                                              int base_j, int r0d, int c0, int T, int causal,
                                              int window, bool masked, float scale,
                                              bool want_p, float (&p_out)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // kKeysMajor: s is (keys, rows), as the dk/dv kernel holds it
      const int ri = kKeysMajor ? base_j + j : base_i + i;
      const int ci = kKeysMajor ? base_i + i : base_j + j;
      float x = s[i][j] * scale;
      if (masked && !live(r0d + ri, c0 + ci, T, causal, window, qseg, kseg, ri, ci)) {
        x = kNegInf;
      }
      float p = expf(x - lse_s[ri]);
      if (x <= kNegInf * 0.5f) p = 0.f;
      if (want_p) p_out[i][j] = p;
      s[i][j] = p * (dp[i][j] - dl_s[ri]) * scale;  // ds
    }
}

template <int D>
__global__ void __launch_bounds__(kF32Threads, 1) flash_f32_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const int32_t* __restrict__ seg, float* __restrict__ dq,
    int T, int G, int H, int causal, int window, int shift, float scale) {
  const int n_tiles = (T + kTile - 1) / kTile;
  const int r0 = (n_tiles - 1 - static_cast<int>(blockIdx.y)) * kTile;
  const int bh = blockIdx.x;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int r_last = min(r0 + kTile, T) - 1;
  const bool has_seg = seg != nullptr;

  extern __shared__ __align__(16) float sm[];
  float* qT = sm;                  // (D, kLdT)
  float* doT = qT + D * kLdT;      // (D, kLdT)
  float* kT = doT + D * kLdT;      // (D, kLdT)
  float* vT = kT + D * kLdT;       // (D, kLdT)
  float* dss = vT + D * kLdT;      // (row, kLdT)
  float* lse_s = dss + kTile * kLdT;
  float* dl_s = lse_s + kTile;
  int* qseg = reinterpret_cast<int*>(dl_s + kTile);
  int* kseg = qseg + kTile;

  const size_t q_off = static_cast<size_t>(bh) * T * D;
  const size_t kv_off = static_cast<size_t>(bh / G) * T * D;
  const int32_t* seg_b = has_seg ? seg + static_cast<size_t>(bh / H) * T : nullptr;
  const Tiles tiles = key_tiles(r0, r_last, n_tiles, causal, window, shift);
  const int r0d = r0 + shift;

  load_t<D>(qT, q + q_off, r0, T, 1.f);
  load_t<D>(doT, dout + q_off, r0, T, 1.f);
  load_vec(lse_s, lse + static_cast<size_t>(bh) * T, r0, T, kPadLse);
  load_vec(dl_s, delta + static_cast<size_t>(bh) * T, r0, T, 0.f);
  if (has_seg) load_vec(qseg, seg_b, r0, T, -1);

  float acc[4][kNC<D>];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kNC<D>; ++j) acc[i][j] = 0.f;
  for (int jt = tiles.lo; jt <= tiles.hi; ++jt) {
    const int c0 = jt * kTile;
    __syncthreads();
    load_t<D>(kT, k + kv_off, c0, T, 1.f);
    load_t<D>(vT, v + kv_off, c0, T, 1.f);
    if (has_seg) load_vec(kseg, seg_b, c0, T, -1);
    __syncthreads();

    float s[4][4] = {}, dp[4][4] = {};
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      outer(s, ld4(qT + d * kLdT + 4 * ty), ld4(kT + d * kLdT + 4 * tx));
      outer(dp, ld4(doT + d * kLdT + 4 * ty), ld4(vT + d * kLdT + 4 * tx));
    }
    float unused[4][4];
    probabilities<false>(s, dp, lse_s, dl_s, has_seg ? qseg : nullptr, kseg, 4 * ty, 4 * tx,
                         r0d, c0, T, causal, window,
                         needs_mask(r0d, c0, T, causal, window, has_seg), scale, false, unused);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      *reinterpret_cast<float4*>(dss + (4 * ty + i) * kLdT + 4 * tx) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    }
    __syncthreads();
    // dq += ds k over the tile's 64 keys, four at a time
#pragma unroll 2
    for (int c = 0; c < kTile; c += 4) {
      float4 d4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) d4[i] = ld4(dss + (4 * ty + i) * kLdT + c);
#pragma unroll
      for (int j = 0; j < kNC<D>; ++j) {
        const int col = tx + 16 * j;
        if (col >= D) continue;
        const float4 k4 = ld4(kT + col * kLdT + c);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = dot4(acc[i][j], d4[i], k4);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + 4 * ty + i;
    if (row >= T) continue;
#pragma unroll
    for (int j = 0; j < kNC<D>; ++j) {
      const int col = tx + 16 * j;
      if (col < D) dq[q_off + static_cast<size_t>(row) * D + col] = acc[i][j];
    }
  }
}

// Hkv_b: kv heads per batch row (the segment ids' row of a kv head)
template <int D>
__global__ void __launch_bounds__(kF32Threads, 1) flash_f32_dkv_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const int32_t* __restrict__ seg, float* __restrict__ dk,
    float* __restrict__ dv, int T, int G, int Hkv_b, int causal, int window, int shift,
    float scale) {
  const int n_tiles = (T + kTile - 1) / kTile;
  const int c0 = static_cast<int>(blockIdx.y) * kTile;
  const int bhkv = blockIdx.x;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int c_last = min(c0 + kTile, T) - 1;
  const bool has_seg = seg != nullptr;

  extern __shared__ __align__(16) float sm[];
  float* kT = sm;                  // (D, kLdT): keys are the tile's rows here
  float* vT = kT + D * kLdT;
  float* qT = vT + D * kLdT;       // (D, kLdT): the streamed query rows
  float* doT = qT + D * kLdT;
  float* pss = doT + D * kLdT;     // (key, kLdT) p^T
  float* dss = pss + kTile * kLdT; // (key, kLdT) ds^T
  float* lse_s = dss + kTile * kLdT;
  float* dl_s = lse_s + kTile;
  int* qseg = reinterpret_cast<int*>(dl_s + kTile);
  int* kseg = qseg + kTile;

  const size_t kv_off = static_cast<size_t>(bhkv) * T * D;
  const int32_t* seg_b = has_seg ? seg + static_cast<size_t>(bhkv / Hkv_b) * T : nullptr;
  const Tiles tiles = query_tiles(c0, c_last, n_tiles, causal, window, shift);

  load_t<D>(kT, k + kv_off, c0, T, 1.f);
  load_t<D>(vT, v + kv_off, c0, T, 1.f);
  if (has_seg) load_vec(kseg, seg_b, c0, T, -1);

  float dk_acc[4][kNC<D>], dv_acc[4][kNC<D>];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kNC<D>; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;
  for (int g = 0; g < G; ++g) {
    const int bh = bhkv * G + g;
    const size_t q_off = static_cast<size_t>(bh) * T * D;
    for (int it = tiles.lo; it <= tiles.hi; ++it) {
      const int r0 = it * kTile;
      __syncthreads();
      load_t<D>(qT, q + q_off, r0, T, 1.f);
      load_t<D>(doT, dout + q_off, r0, T, 1.f);
      load_vec(lse_s, lse + static_cast<size_t>(bh) * T, r0, T, kPadLse);
      load_vec(dl_s, delta + static_cast<size_t>(bh) * T, r0, T, 0.f);
      if (has_seg) load_vec(qseg, seg_b, r0, T, -1);
      __syncthreads();

      // s^T = k q^T and dp^T = v do^T: keys 4 ty.., rows 4 tx..
      float s[4][4] = {}, dp[4][4] = {};
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        outer(s, ld4(kT + d * kLdT + 4 * ty), ld4(qT + d * kLdT + 4 * tx));
        outer(dp, ld4(vT + d * kLdT + 4 * ty), ld4(doT + d * kLdT + 4 * tx));
      }
      const int r0d = r0 + shift;
      float p[4][4];
      probabilities<true>(s, dp, lse_s, dl_s, has_seg ? qseg : nullptr, kseg, 4 * ty, 4 * tx,
                          r0d, c0, T, causal, window,
                          needs_mask(r0d, c0, T, causal, window, has_seg), scale, true, p);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        *reinterpret_cast<float4*>(pss + (4 * ty + i) * kLdT + 4 * tx) =
            make_float4(p[i][0], p[i][1], p[i][2], p[i][3]);
        *reinterpret_cast<float4*>(dss + (4 * ty + i) * kLdT + 4 * tx) =
            make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
      }
      __syncthreads();
      // dv += p^T do and dk += ds^T q over the tile's 64 rows, four at a time
#pragma unroll 2
      for (int r = 0; r < kTile; r += 4) {
        float4 p4[4], d4[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          p4[i] = ld4(pss + (4 * ty + i) * kLdT + r);
          d4[i] = ld4(dss + (4 * ty + i) * kLdT + r);
        }
#pragma unroll
        for (int j = 0; j < kNC<D>; ++j) {
          const int col = tx + 16 * j;
          if (col >= D) continue;
          const float4 do4 = ld4(doT + col * kLdT + r);
          const float4 q4 = ld4(qT + col * kLdT + r);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dv_acc[i][j] = dot4(dv_acc[i][j], p4[i], do4);
            dk_acc[i][j] = dot4(dk_acc[i][j], d4[i], q4);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = c0 + 4 * ty + i;
    if (key >= T) continue;
#pragma unroll
    for (int j = 0; j < kNC<D>; ++j) {
      const int col = tx + 16 * j;
      if (col >= D) continue;
      const size_t at = kv_off + static_cast<size_t>(key) * D + col;
      dk[at] = dk_acc[i][j];
      dv[at] = dv_acc[i][j];
    }
  }
}

// the tiles of T on the grid's y dimension (at most 65,535)
bool shape_ok(int BH, int BHkv, int T, int H) {
  return BHkv >= 1 && BH % BHkv == 0 && T >= 1 && H >= 1 && BH % H == 0 &&
         (T + kTile - 1) / kTile <= 65535;
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta, *seg;
  void *out, *lse_out, *dq, *dk, *dv;
  int BH, BHkv, T, H, causal, window, shift;
  float scale;
  cudaStream_t stream;
};

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// which: 0 forward, 1 dq, 2 dk/dv
template <int D>
int launch(int which, const Args& a) {
  const dim3 block(kF32Threads);
  const int G = a.BH / a.BHkv;
  const int tiles = (a.T + kTile - 1) / kTile;
  cudaError_t err;
  if (which == 0) {
    err = allow_smem(flash_f32_fwd_kernel<D>, kFwdSmem<D>);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_f32_fwd_kernel<D><<<dim3(a.BH, tiles), block, kFwdSmem<D>, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const int32_t*>(a.seg),
        static_cast<float*>(a.out), static_cast<float*>(a.lse_out), a.T, G, a.H, a.causal,
        a.window, a.shift, a.scale);
  } else if (which == 1) {
    err = allow_smem(flash_f32_dq_kernel<D>, kDqSmem<D>);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_f32_dq_kernel<D><<<dim3(a.BH, tiles), block, kDqSmem<D>, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<const int32_t*>(a.seg), static_cast<float*>(a.dq), a.T, G, a.H, a.causal,
        a.window, a.shift, a.scale);
  } else {
    err = allow_smem(flash_f32_dkv_kernel<D>, kDkvSmem<D>);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_f32_dkv_kernel<D><<<dim3(a.BHkv, tiles), block, kDkvSmem<D>, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<const int32_t*>(a.seg), static_cast<float*>(a.dk),
        static_cast<float*>(a.dv), a.T, G, a.H / G, a.causal, a.window, a.shift, a.scale);
  }
  return static_cast<int>(cudaGetLastError());
}

int dispatch(int which, int Dh, const Args& a) {
  switch (Dh) {
    case 8: return launch<8>(which, a);
    case 16: return launch<16>(which, a);
    case 32: return launch<32>(which, a);
    case 64: return launch<64>(which, a);
    case 128: return launch<128>(which, a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int D>
int resources(int which, int* out) {
  switch (which) {
    case 0: return kernel_resources(flash_f32_fwd_kernel<D>, kFwdSmem<D>, out, kF32Threads);
    case 1: return kernel_resources(flash_f32_dq_kernel<D>, kDqSmem<D>, out, kF32Threads);
    case 2: return kernel_resources(flash_f32_dkv_kernel<D>, kDkvSmem<D>, out, kF32Threads);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// The f32 counterparts of flash_fwd_launch (flash_fwd.cu), flash_dq_launch
// and flash_dkv_launch (flash_bwd.cu), with the same arguments: every
// tensor f32 (seg int32 or null), contiguous, 16-byte aligned; Dh is 8,
// 16, 32, 64 or 128. Each returns cudaGetLastError() (or
// cudaErrorInvalidValue for a refused shape).
int flash_f32_fwd_launch(const void* q, const void* k, const void* v, const void* seg,
                         void* out, void* lse, int BH, int BHkv, int T, int Dh, int H,
                         int causal, int window, int q_offset, int kv_offset, float scale,
                         void* stream) {
  if (!shape_ok(BH, BHkv, T, H)) return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.q = q; a.k = k; a.v = v; a.seg = seg; a.out = out; a.lse_out = lse;
  a.BH = BH; a.BHkv = BHkv; a.T = T; a.H = H; a.causal = causal; a.window = window;
  a.shift = q_offset - kv_offset; a.scale = scale;
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch(0, Dh, a);
}

int flash_f32_dq_launch(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* delta, const void* seg, void* dq,
                        int BH, int BHkv, int T, int Dh, int H, int causal, int window,
                        int q_offset, int kv_offset, float scale, void* stream) {
  if (!shape_ok(BH, BHkv, T, H)) return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse = lse; a.delta = delta; a.seg = seg;
  a.dq = dq;
  a.BH = BH; a.BHkv = BHkv; a.T = T; a.H = H; a.causal = causal; a.window = window;
  a.shift = q_offset - kv_offset; a.scale = scale;
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch(1, Dh, a);
}

int flash_f32_dkv_launch(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* delta, const void* seg, void* dk,
                         void* dv, int BH, int BHkv, int T, int Dh, int H, int causal,
                         int window, int q_offset, int kv_offset, float scale, void* stream) {
  if (!shape_ok(BH, BHkv, T, H) || H % (BH / BHkv)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse = lse; a.delta = delta; a.seg = seg;
  a.dk = dk; a.dv = dv;
  a.BH = BH; a.BHkv = BHkv; a.T = T; a.H = H; a.causal = causal; a.window = window;
  a.shift = q_offset - kv_offset; a.scale = scale;
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch(2, Dh, a);
}

// What each kernel takes on this card at head dim Dh: out[0] registers a
// thread, out[1] local (spilled) bytes a thread, out[2] dynamic shared
// memory a block, out[3] resident blocks an SM. which: 0 forward, 1 dq,
// 2 dk/dv.
int flash_f32_resources(int which, int Dh, int* out) {
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
