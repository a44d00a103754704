// Shared pieces of the flash attention kernels (flash_fwd.cu, flash_bwd.cu)
// and the paged chunk kernel (paged_chunk.cu): the tile constants, the head
// dims the kernels are instantiated for, the flash kernels' masks and live
// tile ranges, and the resource query behind each source's C export. The
// products themselves are in flash_mma.cuh.
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

constexpr int kTile = 64;        // query rows and keys per tile
constexpr int kThreads = 128;    // 4 warps
constexpr float kNegInf = -1e30f;
// lse of a query row past T: exp(s - lse) underflows to exactly 0
constexpr float kPadLse = 1e30f;

// the head dims the kernels may be instantiated for (each kernel's C entry
// says which it is)
template <int D>
constexpr bool kHeadDimOk = D == 8 || D == 16 || D == 32 || D == 64 || D == 128;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void zero(float (&acc)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
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

// What `kernel` takes on this card, launched with `threads` threads and
// `smem` bytes of dynamic shared memory: out[0] registers a thread, out[1]
// local (spilled) bytes a thread, out[2] dynamic shared memory a block,
// out[3] resident blocks an SM. Returns a CUDA error code, 0 on success.
template <typename Kernel>
inline int kernel_resources(Kernel kernel, size_t smem, int* out, int threads = kThreads) {
  cudaFuncAttributes attr;
  int blocks = 0;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(smem);
  out[3] = blocks;
  return 0;
}

}  // namespace flash
