// Shared pieces of the flash attention kernels: the tile constants and the
// mask (needs_mask, live) serve flash_fwd.cu and flash_bwd.cu; the rest is
// the forward's f32 product path (the backward's tensor-core pieces are in
// flash_mma.cuh).
//
// The kernels are templated over the head dim D (8, 16, 32 or 64). Every
// operand tile is 64 rows x D head dims, staged from bf16 global memory
// into f32 shared memory laid out for D = 64, either row-major
// (tile[row * kLd + d]) or transposed (tile[d * kLd + row]). A product of
// two tiles runs as an outer product over their shared index x: each of the
// 128 threads owns an 8 x 4 register tile, rows rg*8 .. rg*8+7 (rg = tid /
// 16) by columns cg*4 .. cg*4+3 (cg = tid % 16), and reads two float4 of A
// and one float4 of B per step of x. The 16 threads of one rg are one
// half-warp, so a row-wise reduction over the tile's 64 columns is four
// xor-shuffles.
//
// Masks work on a diagonal shift `delta` = q_offset - kv_offset: row r of
// the q operand sits at global position r + q_offset, key c of the k/v
// operand at c + kv_offset, so causal keeps c <= r + delta and a window
// keeps r + delta - c < window. The kernels pass rows already shifted (r +
// delta) to needs_mask and live. delta = 0 is the single-block case; the
// ring block-pair mode passes the offsets of a rotated k/v block. Padding
// (keys at or past T) stays local to the operands.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr int kMaxDh = 64;       // the largest head dim the kernels take
constexpr int kTile = 64;        // query rows and keys per tile
constexpr int kThreads = 128;    // 4 warps
constexpr int kLd = kTile + 4;   // padded f32 row of a staged tile, float4-aligned
constexpr int kTileFloats = kTile * kLd;
constexpr float kNegInf = -1e30f;
// lse of a query row past T: exp(s - lse) underflows to exactly 0
constexpr float kPadLse = 1e30f;

static_assert(kMaxDh == kTile, "staging assumes square tiles at the largest head dim");

// the head dims the kernels are instantiated for
template <int D>
constexpr bool kHeadDimOk = D == 8 || D == 16 || D == 32 || D == 64;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Stage rows [r0, r0 + kTile) of a (T, D) bf16 matrix into f32 shared
// memory, transposed (dst[d * kLd + row]) and/or row-major (dst[row * kLd +
// d]); either pointer may be null. Rows at or past T read as zeros; head
// dims at or past D are not written. With `scale` != 0 each value is
// multiplied by it in f32 and rounded back to bf16 first (the forward's
// folded softmax scale). Consecutive threads take consecutive rows, so the
// transposed stores hit consecutive banks.
template <int D>
__device__ __forceinline__ void stage(float* dst_t, float* dst_r,
                                      const __nv_bfloat16* __restrict__ src,
                                      int r0, int T, float scale) {
  for (int idx = threadIdx.x; idx < kTile * D / 8; idx += kThreads) {
    const int row = idx & (kTile - 1);
    const int d0 = (idx / kTile) * 8;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + row < T) {
      raw = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r0 + row) * D + d0);
    }
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
    float f[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      f[j] = __bfloat162float(h[j]);
      if (scale != 0.f) f[j] = round_bf16(f[j] * scale);
    }
    if (dst_t != nullptr) {
#pragma unroll
      for (int j = 0; j < 8; ++j) dst_t[(d0 + j) * kLd + row] = f[j];
    }
    if (dst_r != nullptr) {
      float4* r = reinterpret_cast<float4*>(dst_r + row * kLd + d0);
      r[0] = make_float4(f[0], f[1], f[2], f[3]);
      r[1] = make_float4(f[4], f[5], f[6], f[7]);
    }
  }
}

// acc[i][c] += sum over x < N of A[x * kLd + rg*8 + i] * B[x * kLd + cg*4 + c],
// summed in order of x, one fmaf each.
template <int N>
__device__ __forceinline__ void outer_acc(float (&acc)[8][4], const float* A,
                                          const float* B, int rg, int cg) {
#pragma unroll 4
  for (int x = 0; x < N; ++x) {
    const float4 a0 = *reinterpret_cast<const float4*>(A + x * kLd + rg * 8);
    const float4 a1 = *reinterpret_cast<const float4*>(A + x * kLd + rg * 8 + 4);
    const float4 b4 = *reinterpret_cast<const float4*>(B + x * kLd + cg * 4);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(a[i], b[c], acc[i][c]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
}

// Store a thread's 8 x 4 register tile transposed into shared memory:
// dst[(cg*4 + c) * kLd + rg*8 + i] = round_bf16(v[i][c]), as float4 runs.
__device__ __forceinline__ void store_t_bf16(float* dst, const float (&v)[8][4],
                                             int rg, int cg) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    float4* p = reinterpret_cast<float4*>(dst + (cg * 4 + c) * kLd + rg * 8);
    p[0] = make_float4(round_bf16(v[0][c]), round_bf16(v[1][c]),
                       round_bf16(v[2][c]), round_bf16(v[3][c]));
    p[1] = make_float4(round_bf16(v[4][c]), round_bf16(v[5][c]),
                       round_bf16(v[6][c]), round_bf16(v[7][c]));
  }
}

// Write a thread's 8 x 4 register tile, rows r0 + rg*8 + i (those < T),
// columns cg*4 .. cg*4+3 (those < D), to a (T, D) bf16 matrix: one 8-byte
// store a row.
template <int D>
__device__ __forceinline__ void write_rows(__nv_bfloat16* __restrict__ dst,
                                           const float (&v)[8][4], int r0, int T,
                                           int rg, int cg) {
  if (cg * 4 >= D) return;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = r0 + rg * 8 + i;
    if (row >= T) continue;
    __nv_bfloat162 lo = __floats2bfloat162_rn(v[i][0], v[i][1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v[i][2], v[i][3]);
    uint2 packed;
    packed.x = *reinterpret_cast<uint32_t*>(&lo);
    packed.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(dst + static_cast<size_t>(row) * D + cg * 4) = packed;
  }
}

// Whether any (row, key) pair of the tile pair (shifted rows r0.., keys
// c0..) can be masked: the causal diagonal, the window's trailing edge,
// keys past T, or segment ids (runtime data). Elsewhere the per-element
// mask is skipped.
__device__ __forceinline__ bool needs_mask(int r0, int c0, int T, bool causal,
                                           int window, bool has_seg) {
  return has_seg || (causal && c0 + kTile - 1 > r0) ||
         (window > 0 && r0 + kTile - 1 - c0 >= window) || c0 + kTile > T;
}

// row: the shifted row (r + delta); col: the local key.
__device__ __forceinline__ bool live(int row, int col, int T, bool causal, int window,
                                     const int* qseg, const int* kseg, int ri, int ci) {
  bool ok = col < T;
  if (causal) ok = ok && col <= row;
  if (window > 0) ok = ok && row - col < window;
  if (qseg != nullptr) ok = ok && qseg[ri] == kseg[ci];
  return ok;
}

// Segment ids of rows [r0, r0 + kTile) of batch b into shared memory. A
// row past T reads -1; what it matches never counts: keys past T are masked
// by position, and query rows past T are not written (forward, dq) or carry
// kPadLse (dk/dv).
__device__ __forceinline__ void stage_seg(int* dst, const int32_t* __restrict__ seg,
                                          int b, int r0, int T) {
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    dst[r] = r0 + r < T ? seg[static_cast<size_t>(b) * T + r0 + r] : -1;
  }
}

// A range of 64-row tiles, [lo, hi]; lo > hi when it is empty.
struct Tiles {
  int lo, hi;
};

// The live 64-key tiles of the query rows [r0, r_last] under causal/window
// at diagonal shift delta; empty when no key is live (a dead block pair).
__device__ __forceinline__ Tiles key_tiles(int r0, int r_last, int n_tiles, bool causal,
                                           int window, int delta) {
  const int first = r0 + delta - window + 1;  // the lowest key a window lets in
  const int last = r_last + delta;            // the highest key causal lets in
  return {window > 0 ? min(max(first, 0) / kTile, n_tiles) : 0,
          !causal ? n_tiles - 1 : last < 0 ? -1 : min(last / kTile, n_tiles - 1)};
}

// The dual: the live 64-row query tiles of the keys [c0, c_last].
__device__ __forceinline__ Tiles query_tiles(int c0, int c_last, int n_tiles, bool causal,
                                             int window, int delta) {
  const int first = c0 - delta;                  // the lowest row causal lets in
  const int last = c_last + window - 1 - delta;  // the highest row a window lets in
  return {causal ? min(max(first, 0) / kTile, n_tiles) : 0,
          window <= 0 ? n_tiles - 1 : last < 0 ? -1 : min(last / kTile, n_tiles - 1)};
}

}  // namespace flash
