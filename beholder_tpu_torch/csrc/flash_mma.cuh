// Tensor-core pieces of the flash forward (flash_fwd.cu), the flash
// backward (flash_bwd.cu) and the paged chunk kernel (paged_chunk.cu).
//
// What bounds the three kernels at their training and long-context shapes
// is the pair of attention products; on Hopper only the tensor cores run
// them near the card's bf16 rate (f32 FMA loops peak at 67 TFLOP/s, 1/15 of
// it). These pieces run every product as mma.sync bf16 with f32 sums and
// keep the softmax weights in registers between the two products, so
// neither the (64 x 64) score tile nor p ever touches shared memory.
//
// Operand tiles are kTile rows of Dims<D>::kK bf16 values in shared memory:
// the head dim D (8, 16, 32, 64 or 128), zero-padded to the mma's K of 16
// where it is smaller (D = 8; zeros add nothing to a dot product). Each row
// is padded by 8 more values (to 48, 80, 144 or 272 bytes): the eight
// 16-byte rows that one ldmatrix phase reads then fall on 32 distinct
// banks. Tiles arrive by cp.async (16 bytes a thread a copy; rows past T
// and head dims past D zero-filled), or, for the chunk kernel's quantized
// pages, through registers, and are double-buffered by the kernels.
//
// Products run on mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32. Each
// warp owns 16 rows of a (16 x 64) accumulator (scores; or 16 x kK for a
// head-dim-wide output: kK / 8 column tiles), held as acc[n][0..3] for
// the column tiles n of 8 columns: with g = lane / 4 and t = lane % 4,
// acc[n][0..1] sit at row g, columns 8n + 2t, 8n + 2t + 1, and acc[n][2..3]
// at row g + 8, the same columns (frag_row, frag_col). A row's 64 scores
// thus sit in the 4 lanes of one quad. Two adjacent column tiles of an
// accumulator, rounded to bf16 pairs, are exactly the A fragment of the
// next product's 16-wide step of its sum index (to_a), so p and ds go from
// one product into the next in registers.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace flash {

// The tile geometry of head dim D.
template <int D>
struct Dims {
  static_assert(kHeadDimOk<D>, "head dim 8, 16, 32, 64 or 128");
  static constexpr int kK = D < 16 ? 16 : D;  // head dims in shared memory
  static constexpr int kSteps = kK / 16;      // 16-wide mma steps over them
  static constexpr int kN = kK / 8;           // n8 tiles of a head-dim-wide output
  static constexpr int kLd = kK + 8;          // padded bf16 row of a staged tile
  static constexpr int kElems = kTile * kLd;  // bf16 values per staged tile
};

static_assert(kTile == 64, "fragments assume 64-row tiles");
static_assert(kThreads == 128, "one warpgroup: 4 warps of 16 rows");

// The one accumulator element a thread holds at acc[n][e] of its warp's
// 16 x 64 tile: its row (e < 2: g, else g + 8) and column (8n + 2t + e % 2).
__device__ __forceinline__ int frag_row(int e) {
  return ((threadIdx.x & 31) >> 2) + ((e >> 1) << 3);
}
__device__ __forceinline__ int frag_col(int n, int e) {
  return n * 8 + 2 * (threadIdx.x & 3) + (e & 1);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid (src
// is then not read, but must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [r0, r0 + kTile) of a (T, D) bf16 matrix into a padded shared tile;
// rows at or past T and head dims at or past D read as zeros. kK / 8
// consecutive threads copy one row; `tid` (0 .. kThreads - 1) is this
// thread's place among the kThreads that copy the tile.
template <int D>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst,
                                                const __nv_bfloat16* __restrict__ src,
                                                int r0, int T, unsigned tid) {
  using G = Dims<D>;
  constexpr int kChunks = G::kK / 8;  // 16-byte chunks a row
#pragma unroll
  for (int i = 0; i < kTile * kChunks / kThreads; ++i) {
    // unsigned: the divisions by the power of two kChunks are shifts
    const unsigned idx = tid + i * kThreads;
    const int row = static_cast<int>(idx / kChunks);
    const int col = static_cast<int>(idx % kChunks) * 8;
    const bool valid = r0 + row < T && col < D;
    cp_async16(dst + row * G::kLd + col,
               src + (valid ? static_cast<size_t>(r0 + row) * D + col : 0), valid);
  }
}

// The same, copied by a block of kThreads threads.
template <int D>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst,
                                                const __nv_bfloat16* __restrict__ src,
                                                int r0, int T) {
  load_tile_async<D>(dst, src, r0, T, threadIdx.x);
}

// kTile 4-byte values src[r0 + r] into dst[r] (threads lane0 .. lane0 + 63,
// one each); a row at or past T gets `fill`, stored directly.
template <typename V>
__device__ __forceinline__ void load_vec_async(V* dst, const V* __restrict__ src, int r0,
                                               int T, V fill, int lane0) {
  const int r = static_cast<int>(threadIdx.x) - lane0;
  if (r < 0 || r >= kTile) return;
  if (r0 + r < T) {
    cp_async4(dst + r, src + r0 + r);
  } else {
    dst[r] = fill;
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c (16 x 8, f32) += a (16 x 16, bf16) * b (16 x 8, bf16)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A fragments of rows [row0, row0 + 16) of a shared tile, all kK columns:
// a[kk] is the 16-wide step kk of the sum index.
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[Dims<D>::kSteps][4],
                                       const __nv_bfloat16* tile, int row0) {
  using G = Dims<D>;
  const int lane = threadIdx.x & 31;
  const int m = lane >> 3;  // which 8 x 8 matrix this lane addresses
  const __nv_bfloat16* p = tile + (row0 + ((m & 1) << 3) + (lane & 7)) * G::kLd + ((m >> 1) << 3);
#pragma unroll
  for (int kk = 0; kk < G::kSteps; ++kk) ldsm_x4(a[kk], p + kk * 16);
}

// acc (16 x 64) += A (16 x kK) * B^T, B a shared tile whose 64 rows are
// acc's columns and whose kK columns are the sum index (B read as is).
template <int D>
__device__ __forceinline__ void mma_abt(float (&acc)[8][4],
                                        const uint32_t (&a)[Dims<D>::kSteps][4],
                                        const __nv_bfloat16* b) {
  using G = Dims<D>;
  const int lane = threadIdx.x & 31;
  const int m = lane >> 3;
  const __nv_bfloat16* p = b + (((m >> 1) << 3) + (lane & 7)) * G::kLd + ((m & 1) << 3);
#pragma unroll
  for (int kk = 0; kk < G::kSteps; ++kk)
#pragma unroll
    for (int n = 0; n < 8; n += 2) {
      uint32_t r[4];
      ldsm_x4(r, p + n * 8 * G::kLd + kk * 16);
      mma_bf16(acc[n], a[kk], r[0], r[1]);
      mma_bf16(acc[n + 1], a[kk], r[2], r[3]);
    }
}

// As mma_abt, with A's rows [row0, row0 + 16) read from a shared tile one
// 16-wide step at a time instead of held in registers: at head dim 128 a
// resident A would hold 32 registers a thread for each operand.
template <int D>
__device__ __forceinline__ void mma_abt_s(float (&acc)[8][4], const __nv_bfloat16* a_tile,
                                          int row0, const __nv_bfloat16* b) {
  using G = Dims<D>;
  const int lane = threadIdx.x & 31;
  const int m = lane >> 3;
  const __nv_bfloat16* pa =
      a_tile + (row0 + ((m & 1) << 3) + (lane & 7)) * G::kLd + ((m >> 1) << 3);
  const __nv_bfloat16* p = b + (((m >> 1) << 3) + (lane & 7)) * G::kLd + ((m & 1) << 3);
#pragma unroll
  for (int kk = 0; kk < G::kSteps; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, pa + kk * 16);
#pragma unroll
    for (int n = 0; n < 8; n += 2) {
      uint32_t r[4];
      ldsm_x4(r, p + n * 8 * G::kLd + kk * 16);
      mma_bf16(acc[n], a, r[0], r[1]);
      mma_bf16(acc[n + 1], a, r[2], r[3]);
    }
  }
}

// acc (16 x kK) += A (16 x 64) * B, B a shared tile whose 64 rows are the
// sum index and whose kK columns are acc's columns (B read transposed).
template <int D>
__device__ __forceinline__ void mma_ab(float (&acc)[Dims<D>::kN][4], const uint32_t (&a)[4][4],
                                       const __nv_bfloat16* b) {
  using G = Dims<D>;
  const int lane = threadIdx.x & 31;
  const int m = lane >> 3;
  const __nv_bfloat16* p = b + (((m & 1) << 3) + (lane & 7)) * G::kLd + ((m >> 1) << 3);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int n = 0; n < G::kN; n += 2) {
      uint32_t r[4];
      ldsm_x4_trans(r, p + kk * 16 * G::kLd + n * 8);
      mma_bf16(acc[n], a[kk], r[0], r[1]);
      mma_bf16(acc[n + 1], a[kk], r[2], r[3]);
    }
}

// An f32 accumulator (16 x 64) as the bf16 A fragments of a product over
// its 64 columns, each value rounded to nearest even.
__device__ __forceinline__ void to_a(uint32_t (&a)[4][4], const float (&c)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    a[kk][1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    a[kk][2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

// One online-softmax step for row half h of a warp's 16 x 64 score tile (h
// = 0: row g, 1: row g + 8), whose 64 scores sit in the 4 lanes of a quad:
// the row's running max m and sum l take the tile, its scores become p =
// exp(s - m) in f32 (0 where the score is masked, <= -5e29, so a wholly
// masked row adds nothing), l takes the f32 p, and the row's output
// accumulator is rescaled by exp(m_old - m).
template <int N>
__device__ __forceinline__ void online_softmax(float (&s)[8][4], float (&acc)[N][4], int h,
                                               float& m, float& l) {
  float mx = kNegInf;
#pragma unroll
  for (int n = 0; n < 8; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * h], s[n][2 * h + 1]));
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
  const float m_new = fmaxf(m, mx);
  float sum = 0.f;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float x = s[n][2 * h + e];
      float p = expf(x - m_new);
      if (x <= kNegInf * 0.5f) p = 0.f;
      s[n][2 * h + e] = p;
      sum += p;
    }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  sum += __shfl_xor_sync(0xffffffffu, sum, 2);
  const float alpha = expf(m - m_new);
  l = l * alpha + sum;
  m = m_new;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    acc[n][2 * h] *= alpha;
    acc[n][2 * h + 1] *= alpha;
  }
}

// out = acc / max(l, 1e-37) for row half h of a head-dim-wide accumulator
template <int N>
__device__ __forceinline__ void normalize(float (&acc)[N][4], int h, float l) {
  const float denom = fmaxf(l, 1e-37f);
#pragma unroll
  for (int n = 0; n < N; ++n) {
    acc[n][2 * h] /= denom;
    acc[n][2 * h + 1] /= denom;
  }
}

// Write a warp's head-dim-wide accumulator, rows row0 + 0..15 (those < T),
// columns < D, to a (T, D) bf16 matrix, one bf16 pair a store.
template <int D>
__device__ __forceinline__ void store_acc(__nv_bfloat16* __restrict__ dst,
                                          const float (&c)[Dims<D>::kN][4], int row0, int T) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + (lane >> 2) + 8 * h;
    if (row >= T) continue;
    uint32_t* out = reinterpret_cast<uint32_t*>(dst + static_cast<size_t>(row) * D + 2 * (lane & 3));
#pragma unroll
    for (int n = 0; n < Dims<D>::kN; ++n) {
      if (n * 8 < D) out[n * 4] = pack_bf16(c[n][2 * h], c[n][2 * h + 1]);
    }
  }
}

// Write zeros to rows row0 + 0..15 (those < T), columns < D, of a (T, D)
// bf16 matrix: a warp's share of a block pair with nothing live.
template <int D>
__device__ __forceinline__ void store_zeros(__nv_bfloat16* __restrict__ dst, int row0, int T) {
  const int lane = threadIdx.x & 31;
  for (int i = lane; i < 16 * D / 2; i += 32) {
    const int row = row0 + i / (D / 2);
    if (row < T) {
      reinterpret_cast<uint32_t*>(dst + static_cast<size_t>(row) * D)[i % (D / 2)] = 0u;
    }
  }
}

}  // namespace flash
