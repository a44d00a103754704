// Paged-KV chunk attention for Hopper (sm_90a), bound through a plain C
// interface (ctypes) by beholder_tpu_torch/ops/paged_attention.py.
//
// Replaces the TPU kernel beholder_tpu/ops/paged_attention.py::_chunk_kernel
// (launched by _chunk_call, public as paged_chunk_attention). Each slot's
// W-token query chunk, at positions lens[s]..lens[s]+W-1, attends the slot's
// committed positions (< lens[s]) read in place from the (N, Hkv, Dh, page)
// pools through the page table, plus the chunk's own k/v (an overlay that is
// never written to the pool), causally per row and under an optional window.
// Prefix-hit admission (one slot, a suffix over cached pages) and fused-wave
// admission (lens 0: the chunk attends itself only) both run through it.
//
// What bounds it: at the serving shapes, neither bytes nor operations. A
// fused wave (8 x 256 tokens, Dh 64) moves ~5.2 MB of q/out/chunk k/v, about
// 1.6 us at 3.35 TB/s, against ~0.54 GFLOP of causal products (~0.55 us at
// the bf16 tensor-core rate); a warm prefix admit moves ~0.36 MB (~0.11 us).
// Both sit far below a kernel launch, so the floor in practice is latency:
// how fast one block walks its tiles. The TPU kernel's VMEM assembly, DMA
// rounds and slots_per_block grid are not carried over.
//
// What the design does about that: one block per (slot, kv head, tile of 64
// query rows), where the rows are the G x W (group head, chunk row) pairs of
// that kv head, contiguous in q and out. So a wave of 8 slots, 2 kv heads and
// 4 x 256 rows per kv head runs 256 blocks, about two per SM. Each block
// walks 128-token tiles: first the committed context [p_lo*page, lens[s])
// (pages read in place, int8 and fp8 dequantized to bf16 on the way into
// shared memory; a page column at or past live_pages reads as zeros, as the
// reference's assembly has it), then the overlay tiles of the chunk's own k/v,
// only as far as the block's last row can see. A position at or past lens[s]
// is never read from a page. Scores and PV are plain FMA loops over shared
// memory, 8 x 8 scores and 8 rows x max(Dh/16, 1) outputs per thread (at Dh
// 8 half the threads' output column is past the head dim and idle);
// tensor-core products (mma.sync/wgmma) and TMA loads are the next steps.
// Head dims 8, 16, 32 and 64, one instantiation each per pool family: the
// pools keep their (N, Hkv, Dh, page) layout, nothing is padded.
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

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;          // 4 warps
constexpr int kRows = 64;              // query rows per block
constexpr int kKeys = 128;             // keys per tile, one per thread when staging
constexpr int kSStride = kKeys + 1;    // padded score row
constexpr int kKStride = kKeys + 2;    // padded K row (d-major, keys minor)
constexpr float kNegInf = -1e30f;

enum Mode { kBf16 = 0, kInt8 = 1, kFp8 = 2 };

template <int MODE> struct Elem { using T = __nv_bfloat16; };
template <> struct Elem<kInt8> { using T = int8_t; };
template <> struct Elem<kFp8> { using T = __nv_fp8_storage_t; };

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

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

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int DH>
constexpr size_t kSmemBytes =
    sizeof(float) * (kRows * (DH + 1) + kRows * kSStride + 3 * kRows + 2 * kKeys) +
    sizeof(int) * (kRows + 3 * kKeys) +
    sizeof(__nv_bfloat16) * (DH * kKStride + kKeys * (DH + 2));
static_assert(kSmemBytes<64> <= 227 * 1024, "shared memory over the per-block limit");

template <int MODE, int DH>
__global__ void __launch_bounds__(kThreads) paged_chunk_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kc,
    const __nv_bfloat16* __restrict__ vc, const void* __restrict__ k_pool,
    const void* __restrict__ v_pool, const void* __restrict__ k_scale,
    const void* __restrict__ v_scale, const int32_t* __restrict__ table,
    const int32_t* __restrict__ lens, __nv_bfloat16* __restrict__ out, int H,
    int Hkv, int W, int page, int N, int P, int live_pages, int ctx_len,
    int window, float sqrt_dh) {
  using T = typename Elem<MODE>::T;
  constexpr int kCols = DH < 16 ? 1 : DH / 16;  // output columns per thread
  const int s = blockIdx.x;
  const int kvh = blockIdx.y;
  const int G = H / Hkv;
  const int GW = G * W;
  const int r0 = blockIdx.z * kRows;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int rg = tid >> 4;  // this thread's rows: rg*8 .. rg*8+7
  const int cg = tid & 15;  // its keys cg + 16c, and output columns cg + 16c

  extern __shared__ float smem[];
  float* q_s = smem;                            // (kRows, DH+1) queries
  float* s_s = q_s + kRows * (DH + 1);          // (kRows, kSStride) scores, then p
  float* m_s = s_s + kRows * kSStride;          // (kRows,) running max
  float* l_s = m_s + kRows;                     // (kRows,) running sum
  float* alpha_s = l_s + kRows;                 // (kRows,) this tile's rescale
  float* sk_s = alpha_s + kRows;                // (kKeys,) K scales of the tile
  float* sv_s = sk_s + kKeys;                   // (kKeys,) V scales of the tile
  int* jrow_s = reinterpret_cast<int*>(sv_s + kKeys);  // (kRows,) chunk row j, -1 past the end
  int* kpos_s = jrow_s + kRows;                 // (kKeys,) key position, -1 if none
  int* ksrc_s = kpos_s + kKeys;                 // (kKeys,) page id; -1 zeros
  int* koff_s = ksrc_s + kKeys;                 // (kKeys,) token in page / chunk row
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(koff_s + kKeys);  // (DH, kKStride)
  __nv_bfloat16* v_s = k_s + DH * kKStride;                               // (kKeys, DH+2)

  // q and out (S, H, W, DH): this kv head's G*W rows are contiguous
  const size_t qo_base = (static_cast<size_t>(s) * H + static_cast<size_t>(kvh) * G) * W * DH;
  for (int i = tid; i < kRows * DH; i += kThreads) {
    const int r = i / DH;
    const int d = i - r * DH;
    const int gr = r0 + r;
    q_s[r * (DH + 1) + d] = gr < GW ? __bfloat162float(q[qo_base + static_cast<size_t>(gr) * DH + d]) : 0.f;
  }
  for (int r = tid; r < kRows; r += kThreads) {
    const int gr = r0 + r;
    jrow_s[r] = gr < GW ? gr % W : -1;
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  // the block's smallest and largest chunk row
  const int r_last = min(r0 + kRows, GW) - 1;
  int jmin = r0 % W, jmax = r_last % W;
  if (r0 / W != r_last / W) {
    jmin = 0;
    jmax = W - 1;
  }
  const int len = max(lens[s], 0);
  const int hi = min(len, ctx_len);  // committed context: [lo, hi)
  const int lo = window > 0 ? (max(len - (window - 1), 0) / page) * page : 0;
  const int n_ctx = hi > lo ? (hi - lo + kKeys - 1) / kKeys : 0;
  const int n_ov = (min(jmax + 1, W) + kKeys - 1) / kKeys;
  const size_t kv_head = static_cast<size_t>(kvh) * DH;

  float acc[8][kCols];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  __syncthreads();

  for (int t = 0; t < n_ctx + n_ov; ++t) {
    const bool ov = t >= n_ctx;
    const int base = ov ? (t - n_ctx) * kKeys : lo + t * kKeys;  // chunk row or position
    // positions this tile spans, for skipping it whole
    const int first = ov ? len + base : base;
    const int last = ov ? len + min(base + kKeys, W) - 1 : min(base + kKeys, hi) - 1;
    if (window > 0 && last <= len + jmin - window) continue;  // before every row's window
    if (first > len + jmax) continue;                           // after every row

    // per key: where it comes from and where it sits (thread tid = key tid)
    {
      const int i = tid;
      int pos = -1, src = -1, off = 0;
      if (ov) {
        const int o = base + i;
        if (o < W && len + o < ctx_len) {
          pos = len + o;
          off = o;
        }
      } else {
        const int p = base + i;
        if (p < hi) {
          pos = p;
          const int col = p / page;
          off = p - col * page;
          if (col < live_pages) {
            // a page id outside the pool is clamped: the read stays inside
            src = min(max(table[static_cast<size_t>(s) * P + col], 0), N - 1);
            if (MODE != kBf16) {
              const size_t sidx = (static_cast<size_t>(src) * Hkv + kvh) * page + off;
              sk_s[i] = load_scale<MODE>(k_scale, sidx);
              sv_s[i] = load_scale<MODE>(v_scale, sidx);
            }
          }
        }
      }
      kpos_s[i] = pos;
      ksrc_s[i] = src;
      koff_s[i] = off;
    }
    __syncthreads();

    // stage K (d-major) and V (key-major) as bf16; keys with no source are
    // exact zeros, so a zero weight never meets a stale value
    if (ov) {
      const size_t cbase = (static_cast<size_t>(s) * Hkv + kvh) * W * DH;
      for (int idx = tid; idx < kKeys * DH; idx += kThreads) {
        const int key = idx / DH;
        const int d = idx - key * DH;
        __nv_bfloat16 kv = __float2bfloat16_rn(0.f), vv = kv;
        if (kpos_s[key] >= 0) {
          const size_t e = cbase + static_cast<size_t>(koff_s[key]) * DH + d;
          kv = kc[e];
          vv = vc[e];
        }
        k_s[d * kKStride + key] = kv;
        v_s[key * (DH + 2) + d] = vv;
      }
    } else {
      const T* kp = static_cast<const T*>(k_pool);
      const T* vp = static_cast<const T*>(v_pool);
      for (int idx = tid; idx < kKeys * DH; idx += kThreads) {
        const int key = idx & (kKeys - 1);
        const int d = idx / kKeys;
        __nv_bfloat16 kv = __float2bfloat16_rn(0.f), vv = kv;
        const int src = ksrc_s[key];
        if (kpos_s[key] >= 0 && src >= 0) {
          const size_t e = ((static_cast<size_t>(src) * Hkv) * DH + kv_head + d) * page + koff_s[key];
          kv = dequant<MODE>(kp[e], MODE == kBf16 ? 1.f : sk_s[key]);
          vv = dequant<MODE>(vp[e], MODE == kBf16 ? 1.f : sv_s[key]);
        }
        k_s[d * kKStride + key] = kv;
        v_s[key * (DH + 2) + d] = vv;
      }
    }
    __syncthreads();

    // scores: rows rg*8+i, keys cg+16c
    {
      float sc[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) sc[i][c] = 0.f;
#pragma unroll 4
      for (int d = 0; d < DH; ++d) {
        float qv[8], kv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) qv[i] = q_s[(rg * 8 + i) * (DH + 1) + d];
#pragma unroll
        for (int c = 0; c < 8; ++c) kv[c] = __bfloat162float(k_s[d * kKStride + cg + 16 * c]);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int c = 0; c < 8; ++c) sc[i][c] = fmaf(qv[i], kv[c], sc[i][c]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = rg * 8 + i;
        const int j = jrow_s[r];
        const int qpos = len + j;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int key = cg + 16 * c;
          const int kpos = kpos_s[key];
          const bool live = j >= 0 && kpos >= 0 && kpos <= qpos &&
                            (window <= 0 || kpos > qpos - window);
          s_s[r * kSStride + key] = live ? round_bf16(sc[i][c]) / sqrt_dh : kNegInf;
        }
      }
    }
    __syncthreads();

    // online softmax, one warp per 16 rows; p is rounded to bf16 in place
    for (int r = warp; r < kRows; r += kThreads / 32) {
      float* row = s_s + r * kSStride;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < kKeys / 32; ++c) mx = fmaxf(mx, row[lane + 32 * c]);
      mx = warp_max(mx);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < kKeys / 32; ++c) {
        const float x = row[lane + 32 * c];
        float p = expf(x - m_new);
        if (x <= kNegInf * 0.5f) p = 0.f;
        sum += p;
        row[lane + 32 * c] = round_bf16(p);
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(fminf(m_old - m_new, 0.f));
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
        alpha_s[r] = alpha;
      }
    }
    __syncthreads();

    // PV: rows rg*8+i, output columns cg+16c
    {
      const int n_keys = ov ? min(kKeys, W - base) : min(kKeys, hi - base);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float a = alpha_s[rg * 8 + i];
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[i][c] *= a;
      }
      for (int key = 0; key < n_keys; ++key) {
        float pv[8], vv[kCols];
#pragma unroll
        for (int i = 0; i < 8; ++i) pv[i] = s_s[(rg * 8 + i) * kSStride + key];
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          vv[c] = cg + 16 * c < DH ? __bfloat162float(v_s[key * (DH + 2) + cg + 16 * c]) : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = rg * 8 + i;
    const int gr = r0 + r;
    if (gr >= GW) continue;
    const float denom = fmaxf(l_s[r], 1e-37f);
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      if (cg + 16 * c >= DH) continue;
      out[qo_base + static_cast<size_t>(gr) * DH + cg + 16 * c] =
          __float2bfloat16_rn(acc[i][c] / denom);
    }
  }
}

template <int DH>
int launch(int mode, const void* q, const void* kc, const void* vc, const void* k_pool,
           const void* v_pool, const void* k_scale, const void* v_scale, const void* table,
           const void* lens, void* out, int S, int H, int Hkv, int W, int page, int N,
           int P, int live_pages, int ctx_len, int window, float sqrt_dh,
           cudaStream_t stream) {
  decltype(&paged_chunk_kernel<kBf16, DH>) kernel;
  switch (mode) {
    case kBf16: kernel = paged_chunk_kernel<kBf16, DH>; break;
    case kInt8: kernel = paged_chunk_kernel<kInt8, DH>; break;
    case kFp8: kernel = paged_chunk_kernel<kFp8, DH>; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmemBytes<DH>));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(S, Hkv, (H / Hkv * W + kRows - 1) / kRows);
  kernel<<<grid, kThreads, kSmemBytes<DH>, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(kc),
      static_cast<const __nv_bfloat16*>(vc), k_pool, v_pool, k_scale, v_scale,
      static_cast<const int32_t*>(table), static_cast<const int32_t*>(lens),
      static_cast<__nv_bfloat16*>(out), H, Hkv, W, page, N, P, live_pages, ctx_len,
      window, sqrt_dh);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// mode: 0 bf16 pools, 1 int8 pools with f32 scales, 2 fp8 e4m3 pools with
// uint8 E8M0 scales. Dh is 8, 16, 32 or 64. window <= 0 means none.
// Returns cudaGetLastError() (or cudaErrorInvalidValue for a refused shape).
int paged_chunk_launch(const void* q, const void* kc, const void* vc,
                       const void* k_pool, const void* v_pool, const void* k_scale,
                       const void* v_scale, const void* table, const void* lens,
                       void* out, int S, int H, int Hkv, int W, int Dh, int page,
                       int N, int P, int live_pages, int ctx_len, int window,
                       int mode, float sqrt_dh, void* stream) {
  if (Hkv < 1 || H % Hkv || page < 1 || N < 1 || P < 1 ||
      live_pages < 0 || live_pages > P || ctx_len < P * page) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (S == 0 || W == 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
#define PAGED_CHUNK_ARGS mode, q, kc, vc, k_pool, v_pool, k_scale, v_scale, table, lens, out, \
    S, H, Hkv, W, page, N, P, live_pages, ctx_len, window, sqrt_dh, st
  switch (Dh) {
    case 8: return launch<8>(PAGED_CHUNK_ARGS);
    case 16: return launch<16>(PAGED_CHUNK_ARGS);
    case 32: return launch<32>(PAGED_CHUNK_ARGS);
    case 64: return launch<64>(PAGED_CHUNK_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PAGED_CHUNK_ARGS
}

}  // extern "C"
