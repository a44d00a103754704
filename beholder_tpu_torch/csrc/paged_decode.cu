// Paged-KV decode attention for Hopper (sm_90a), bound through a plain C
// interface (ctypes) by beholder_tpu_torch/ops/paged_attention.py.
//
// Replaces the TPU kernel beholder_tpu/ops/paged_attention.py::_paged_kernel
// (launched by _paged_call, public as paged_decode_attention). Each slot's
// single query attends its own live pages, read in place from the
// (N, Hkv, Dh, page) pools through the page table; int8 and fp8 pages are
// dequantized right after the load.
//
// What bounds it: the bytes of the live K/V pages (plus their scales). Per
// (slot, kv head) the work is 4 * G * Dh flops for every 2 * Dh values read,
// far below the card's ~295 flops per byte, so it is a memory-bound gather.
//
// What the design does about that: it reads every live K/V element exactly
// once and nothing of a page beyond the slot's length or before its window.
// Tiles of at most 128 tokens are staged into shared memory by the whole
// block with 16-byte loads (the pool keeps tokens minor, so each (head, d)
// row of a tile is contiguous), K and V together, so each thread keeps many
// loads in flight; int8/fp8 values are dequantized to bf16 on the way in.
// One block serves one (slot, kv head) and all G query heads of that group,
// so every K/V element loaded feeds G dot products: scores come from one
// thread per token, the online softmax runs one warp per head, and the PV
// product is a reduction over the tile's tokens. This first design uses
// slots * Hkv blocks, fewer than the card's 132 SMs at the serving shapes,
// and each walks its pages in order; splitting the page walk across blocks
// (flash-decoding) and overlapping the next tile's loads with this tile's
// math are the next steps.
//
// The arithmetic is the TPU kernel's (ops/paged_attention.py:265-353):
// - bf16 pools: q in bf16, each score a bf16 x bf16 product summed in f32,
//   rounded to bf16 and back, then multiplied by 1/sqrt(Dh);
// - int8 / fp8 pools: values to f32, times the decoded scale, rounded to
//   bf16; their scores are not rounded;
// - online softmax in f32, p zeroed where the score is <= -5e29, p cast to
//   bf16 before the PV product, which accumulates in f32;
// - out = acc / max(l, 1e-37) in bf16; lens[s] == -1 is a dead slot: no
//   page is read and its output row is zero.
// Tiles wholly outside [len - window + 1, len] are skipped: in the TPU
// kernel they contribute exact zeros, so skipping them changes no bit.
// Only the grouping of the online softmax differs from the TPU kernel for
// pages larger than 128 tokens (ULPs).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;             // tokens per tile, one per thread
constexpr int kStride = kThreads + 2;     // padded smem row: conflict-free reads
constexpr int kMaxG = 16;                 // query heads per kv head
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

// one pool element to the bf16 the math uses: bf16 as is; int8 and fp8 to
// f32, times the decoded scale, rounded to bf16 (the TPU kernel's order)
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

// Stage one tile (Dh rows of `tile` tokens starting at `base`) of K and of V
// into shared memory as bf16, rows `kStride` apart. 16-byte loads where the
// page and the pool pointers allow them, element loads otherwise.
template <int MODE>
__device__ __forceinline__ void stage_kv(
    const void* __restrict__ k_pool, const void* __restrict__ v_pool,
    size_t base, int page, int tile, int Dh, const float* sk, const float* sv,
    __nv_bfloat16* k_s, __nv_bfloat16* v_s, int tid) {
  using T = typename Elem<MODE>::T;
  constexpr int kVec = 16 / sizeof(T);
  const T* ksrc = static_cast<const T*>(k_pool) + base;
  const T* vsrc = static_cast<const T*>(v_pool) + base;
  const bool aligned = page % kVec == 0 &&
                       (reinterpret_cast<uintptr_t>(ksrc) & 15) == 0 &&
                       (reinterpret_cast<uintptr_t>(vsrc) & 15) == 0;
  if (aligned) {
    const int per_row = tile / kVec;  // tile is a multiple of kVec here
    const int total = Dh * per_row;
#pragma unroll 4
    for (int c = tid; c < total; c += kThreads) {
      const int d = c / per_row;
      const int j = (c - d * per_row) * kVec;
      const size_t off = static_cast<size_t>(d) * page + j;
      const uint4 kr = *reinterpret_cast<const uint4*>(ksrc + off);
      const uint4 vr = *reinterpret_cast<const uint4*>(vsrc + off);
      const T* ke = reinterpret_cast<const T*>(&kr);
      const T* ve = reinterpret_cast<const T*>(&vr);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        k_s[d * kStride + j + e] = dequant<MODE>(ke[e], MODE == kBf16 ? 1.f : sk[j + e]);
        v_s[d * kStride + j + e] = dequant<MODE>(ve[e], MODE == kBf16 ? 1.f : sv[j + e]);
      }
    }
  } else {
    const int total = Dh * tile;
    for (int c = tid; c < total; c += kThreads) {
      const int d = c / tile;
      const int j = c - d * tile;
      const size_t off = static_cast<size_t>(d) * page + j;
      k_s[d * kStride + j] = dequant<MODE>(ksrc[off], MODE == kBf16 ? 1.f : sk[j]);
      v_s[d * kStride + j] = dequant<MODE>(vsrc[off], MODE == kBf16 ? 1.f : sv[j]);
    }
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

template <int MODE>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const __nv_bfloat16* __restrict__ q, const void* __restrict__ k_pool,
    const void* __restrict__ v_pool, const void* __restrict__ k_scale,
    const void* __restrict__ v_scale, const int32_t* __restrict__ table,
    const int32_t* __restrict__ lens, __nv_bfloat16* __restrict__ out, int H,
    int Hkv, int Dh, int page, int N, int P, int window, float scale) {
  const int s = blockIdx.x;
  const int kvh = blockIdx.y;
  const int G = H / Hkv;
  const int GD = G * Dh;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  extern __shared__ float smem[];
  float* q_s = smem;                    // (G, Dh) the group's queries
  float* acc_s = q_s + GD;              // (G, Dh) unnormalised output
  float* p_s = acc_s + GD;              // (G, kThreads) scores, then bf16 p
  float* m_s = p_s + G * kThreads;      // (G,) running max
  float* l_s = m_s + G;                 // (G,) running sum
  float* alpha_s = l_s + G;             // (G,) this tile's rescale
  float* sk_s = alpha_s + G;            // (kThreads,) this tile's K scales
  float* sv_s = sk_s + kThreads;        // (kThreads,) this tile's V scales
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(sv_s + kThreads);  // (Dh, kStride)
  __nv_bfloat16* v_s = k_s + Dh * kStride;                                  // (Dh, kStride)

  // q (S, H, Dh) and out (S, H, Dh): this group's heads are contiguous
  const size_t qo_base = (static_cast<size_t>(s) * H + static_cast<size_t>(kvh) * G) * Dh;
  for (int i = tid; i < GD; i += kThreads) {
    q_s[i] = __bfloat162float(q[qo_base + i]);
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  __syncthreads();

  const int len = lens[s];
  if (len >= 0) {
    // live pages hold positions 0..len, clamped to the table's width
    const int n_hi = min(len / page + 1, P);
    const int p_lo = window > 0 ? max(len - (window - 1), 0) / page : 0;
    const int lo_pos = window > 0 ? len - window : -1;  // pos <= lo_pos masked
    for (int i = p_lo; i < n_hi; ++i) {
      // a page id outside the pool (a table the allocator never wrote)
      // is clamped: the read stays inside the pool
      const size_t pid = static_cast<size_t>(
          min(max(table[static_cast<size_t>(s) * P + i], 0), N - 1));
      const size_t head_base = (pid * Hkv + kvh) * static_cast<size_t>(Dh) * page;
      const size_t scale_base = (pid * Hkv + kvh) * static_cast<size_t>(page);
      for (int t0 = 0; t0 < page; t0 += kThreads) {
        const int first = i * page + t0;
        if (first > len) break;  // the rest of the page is past the query
        const int tile = min(kThreads, page - t0);
        if (first + tile - 1 <= lo_pos) continue;  // wholly before the window
        const int pos = first + tid;
        const bool in_tile = tid < tile;
        const bool live = in_tile && pos <= len && pos > lo_pos;

        if (MODE != kBf16) {
          if (in_tile) {
            sk_s[tid] = load_scale<MODE>(k_scale, scale_base + t0 + tid);
            sv_s[tid] = load_scale<MODE>(v_scale, scale_base + t0 + tid);
          }
          __syncthreads();
        }
        stage_kv<MODE>(k_pool, v_pool, head_base + t0, page, tile, Dh, sk_s, sv_s,
                       k_s, v_s, tid);
        __syncthreads();

        // scores: one thread per token
        float sc[kMaxG];
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) sc[g] = 0.f;
        if (in_tile) {
          for (int d = 0; d < Dh; ++d) {
            const float kv = __bfloat162float(k_s[d * kStride + tid]);
#pragma unroll
            for (int g = 0; g < kMaxG; ++g) {
              if (g < G) sc[g] = fmaf(q_s[g * Dh + d], kv, sc[g]);
            }
          }
          if (!live) {
            // a masked token's p is 0; its V column becomes exact zeros so
            // that 0 never meets whatever the pool holds past the length
            for (int d = 0; d < Dh; ++d) v_s[d * kStride + tid] = __float2bfloat16_rn(0.f);
          }
        }
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) {
          if (g < G) {
            float x = sc[g];
            if (MODE == kBf16) x = round_bf16(x);
            p_s[g * kThreads + tid] = live ? x * scale : kNegInf;
          }
        }
        __syncthreads();

        // online softmax, one warp per query head
        for (int g = warp; g < G; g += kThreads / 32) {
          float* row = p_s + g * kThreads;
          float mx = kNegInf;
          for (int j = lane; j < kThreads; j += 32) mx = fmaxf(mx, row[j]);
          mx = warp_max(mx);
          const float m_old = m_s[g];
          const float m_new = fmaxf(m_old, mx);
          float sum = 0.f;
          for (int j = lane; j < kThreads; j += 32) {
            const float x = row[j];
            float p = expf(x - m_new);
            if (x <= kNegInf * 0.5f) p = 0.f;
            sum += p;
            row[j] = round_bf16(p);
          }
          sum = warp_sum(sum);
          if (lane == 0) {
            const float alpha = expf(fminf(m_old - m_new, 0.f));
            l_s[g] = l_s[g] * alpha + sum;
            m_s[g] = m_new;
            alpha_s[g] = alpha;
          }
        }
        __syncthreads();

        // PV: each thread owns outputs tid, tid + 128, ... of (G, Dh)
        for (int o = tid; o < GD; o += kThreads) {
          const int g = o / Dh;
          const int d = o - g * Dh;
          const float* prow = p_s + g * kThreads;
          const __nv_bfloat16* vrow = v_s + d * kStride;
          float pv = 0.f;
          for (int j = 0; j < tile; ++j) pv = fmaf(prow[j], __bfloat162float(vrow[j]), pv);
          acc_s[o] = acc_s[o] * alpha_s[g] + pv;
        }
        __syncthreads();
      }
    }
  }

  for (int o = tid; o < GD; o += kThreads) {
    out[qo_base + o] = __float2bfloat16_rn(acc_s[o] / fmaxf(l_s[o / Dh], 1e-37f));
  }
}

template <int MODE>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* k_scale, const void* v_scale, const void* table,
                   const void* lens, void* out, int S, int H, int Hkv, int Dh,
                   int page, int N, int P, int window, float scale, size_t smem,
                   cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_decode_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(S, Hkv);
  paged_decode_kernel<MODE><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), k_pool, v_pool, k_scale, v_scale,
      static_cast<const int32_t*>(table), static_cast<const int32_t*>(lens),
      static_cast<__nv_bfloat16*>(out), H, Hkv, Dh, page, N, P, window, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one block needs, in bytes (0 when the shape is refused).
size_t paged_decode_smem_bytes(int H, int Hkv, int Dh) {
  if (Hkv < 1 || H % Hkv || H / Hkv > kMaxG || Dh < 1) return 0;
  const int G = H / Hkv;
  return sizeof(float) * (2 * G * Dh + G * kThreads + 3 * G + 2 * kThreads) +
         sizeof(__nv_bfloat16) * 2 * static_cast<size_t>(Dh) * kStride;
}

// mode: 0 bf16 pools, 1 int8 pools with f32 scales, 2 fp8 e4m3 pools with
// uint8 E8M0 scales. window <= 0 means none. Returns cudaGetLastError().
int paged_decode_launch(const void* q, const void* k_pool, const void* v_pool,
                        const void* k_scale, const void* v_scale,
                        const void* table, const void* lens, void* out, int S,
                        int H, int Hkv, int Dh, int page, int N, int P,
                        int window, int mode, float scale, void* stream) {
  const size_t smem = paged_decode_smem_bytes(H, Hkv, Dh);
  if (smem == 0 || smem > 227 * 1024 || page < 1 || N < 1 || P < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (S == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (mode) {
    case kBf16:
      err = launch<kBf16>(q, k_pool, v_pool, k_scale, v_scale, table, lens, out,
                          S, H, Hkv, Dh, page, N, P, window, scale, smem, st);
      break;
    case kInt8:
      err = launch<kInt8>(q, k_pool, v_pool, k_scale, v_scale, table, lens, out,
                          S, H, Hkv, Dh, page, N, P, window, scale, smem, st);
      break;
    case kFp8:
      err = launch<kFp8>(q, k_pool, v_pool, k_scale, v_scale, table, lens, out,
                         S, H, Hkv, Dh, page, N, P, window, scale, smem, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
