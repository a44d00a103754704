// Paged-KV decode attention for Hopper (sm_90a), bound through a plain C
// interface (ctypes) by beholder_tpu_torch/ops/paged_attention.py.
//
// Replaces the TPU kernel beholder_tpu/ops/paged_attention.py::_paged_kernel
// (launched by _paged_call, public as paged_decode_attention). Each slot's
// single query attends its own live positions, read in place from the
// (N, Hkv, Dh, page) pools through the page table; int8 and fp8 pages are
// dequantized where each value is read.
//
// What bounds it: the bytes of the live K/V pages (plus their scales). Per
// (slot, kv head) the work is 4 * G * Dh flops for every 2 * Dh values read,
// G flops a byte on bf16 pools (64 at most at the shapes served here)
// against the ~295 at which the tensor cores rather than the memory would
// set the limit. So it is a memory-bound
// gather, and no tensor cores: with mma.sync and the G query heads as the M
// rows, three quarters of every product would be padding at G = 4, and no
// byte would be saved. At the serving shapes the live bytes are a few MB or
// less, microseconds at 3.35 TB/s, so what the design has to beat is
// latency: too few blocks, and loads waited for one tile at a time.
//
// The design:
// - The split (flash-decoding). The grid is (slots, Hkv, splits); split j
//   owns the fixed run of table positions [j * span, (j + 1) * span), span
//   a multiple of the 64-token tile. The host chooses splits and span from
//   the shapes alone (ops/paged_attention.py decode_splits), never from
//   lens, which lives on the card, so a launch reads nothing back. A block
//   intersects its run with the slot's live positions [max(0, len - window
//   + 1), len], clamped to the table's P * page; a block whose part is
//   empty, a dead slot's (len == -1) included, writes an empty partial.
// - The combine, in the same launch. Each block writes its partial (f32 m
//   and l per query head, f32 acc (G, Dh)) to a workspace, then takes an
//   atomic ticket on its (slot, kv head)'s counter after __threadfence().
//   The block that draws the last ticket sets the counter back to 0 (so the
//   wrapper's counters, zeroed once when made, need no clearing per call)
//   and merges the splits in the fixed order 0 .. n - 1: m = max m_j, l =
//   sum l_j e^(m_j - m), acc = sum acc_j e^(m_j - m), out = acc / max(l,
//   1e-37) in bf16. With one split a block writes out directly and touches
//   neither. Tickets decide only who merges, never an order of sums, so two
//   launches give the same bits.
// - Loads in flight. A block walks its run in chunks of at most 64 tokens
//   that stay inside one page, through a ring of three shared-memory stages:
//   the loads of chunk i + 2 are issued before chunk i's math, one
//   __syncthreads a chunk. Where the page size and the pointers allow it
//   (page a multiple of 16 bytes of tokens, 16-byte aligned pools) the d-
//   major (Dh, chunk) slab of K and of V goes by cp.async, 16 bytes a copy,
//   for every pool family: int8 and fp8 bytes land raw, with their scales,
//   and each value is dequantized where it is read, which is exactly once
//   (below), with the arithmetic the TPU kernel applies as it loads. Else
//   element loads into the same stages. The table entry of the next chunk
//   is loaded a chunk ahead.
// - Spread work. Eight warps (256 threads) a block, each owning 8 tokens
//   of a chunk and keeping its own online softmax (m, l per head) and
//   accumulator, so no barrier separates scores, softmax and PV. Scores:
//   lane (token t = lane % 8, quarter = lane / 8) sums the head dims d with
//   d % 4 == quarter for every head, each K value read once for G dot
//   products, q read as 16-byte head-minor vectors; two shuffles add the
//   quarters. Softmax: a head's 8 scores sit in 8 lanes; max and sum by
//   shuffles, every head's interleaved. PV: lane owns head dims lane, lane
//   + 32, ..., reads its 8 V values once for all G heads, and sums 8
//   products an output a chunk into its warp's accumulator in shared
//   memory, every load before the stores. At the end the eight warps merge
//   in warp order through shared memory, the rule of the splits' merge.
//   Per chunk this is ~2,800 cycles of dependent latency (shuffles, shared
//   memory), not of bandwidth: with one block an SM at the headline shape,
//   each scheduler runs two warps. Heads are held in registers in two
//   instantiations, G <= 4 and G <= 16.
// - More than 16 query heads a kv head (an MQA model of 32 heads over one
//   kv head): the group's G heads go in hsplit equal chunks of at most 16
//   (head_split: the fewest chunks that divide G), a chunk a block along the
//   grid's kv-head axis, which runs Hkv * hsplit virtual kv heads. Each
//   chunk's blocks read their kv head's pages (the group reads them hsplit
//   times, from L2 after the first), and each chunk has its own split
//   partials and ticket, so a chunk's heads get the bits of a launch over
//   that chunk alone. A chunk's q and out rows are contiguous, as a group's
//   are. Registers cap the heads a block holds; 64 heads in one block would
//   hold 64 scores, maxima and sums a thread.
// What is left for later: the fixed chain before the first chunk's math
// (len and the run's first table entry, then the chunk: two dependent
// loads) and the combine's ticket and reads, which are most of a one-chunk
// block's time; TMA bulk copies in place of cp.async; a split over the
// context shared with the chunk kernel's long shape.
//
// The arithmetic is the TPU kernel's (ops/paged_attention.py:265-353),
// within each split:
// - bf16 pools: q in bf16, each score a bf16 x bf16 product summed in f32,
//   rounded to bf16 and back, then multiplied by 1/sqrt(Dh);
// - int8 / fp8 pools: values to f32, times the decoded scale, rounded to
//   bf16; their scores are not rounded;
// - online softmax in f32, p zeroed where the score is <= -5e29, p cast to
//   bf16 before the PV product, which accumulates in f32;
// - out = acc / max(l, 1e-37) in bf16; lens[s] == -1 is a dead slot: no
//   page is read and its output row is exact zeros. A table entry outside
//   the pool is clamped, so the read stays inside it.
// Positions outside the live range contribute exact zeros in the TPU kernel;
// here they are never summed. Only the grouping of the softmax (per warp,
// per split) and the order of the f32 sums differ from the TPU kernel's.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;             // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;                 // tokens a chunk at most
constexpr int kWarpTokens = kTile / kWarps;  // 8 tokens a warp
constexpr int kStages = 3;
constexpr int kMaxG = 16;                 // query heads a block holds
constexpr int kMaxSplits = 64;
constexpr float kNegInf = -1e30f;

enum Mode { kBf16 = 0, kInt8 = 1, kFp8 = 2 };

template <int MODE> struct Elem { using T = __nv_bfloat16; };
template <> struct Elem<kInt8> { using T = int8_t; };
template <> struct Elem<kFp8> { using T = __nv_fp8_storage_t; };

// a staged (d) row: kTile tokens plus 16 bytes, so the rows read at once
// fall on other banks (the score loop's four lane groups read rows d .. d +
// 3; PV's lanes rows d, d + 1, ...)
template <int MODE>
constexpr int kRowBytes = kTile * static_cast<int>(sizeof(typename Elem<MODE>::T)) + 16;
constexpr int kScaleBytes = kTile * 4;  // one stage's K or V scales (f32 or uint8)

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// scale of token t of a staged chunk: int8 pools f32, fp8 pools uint8 E8M0,
// 2**(e - 127) built from the f32 exponent field, never exp2
template <int MODE>
__device__ __forceinline__ float scale_at(const unsigned char* sc, int t) {
  if constexpr (MODE == kInt8) {
    return reinterpret_cast<const float*>(sc)[t];
  } else if constexpr (MODE == kFp8) {
    return __int_as_float(static_cast<int>(sc[t]) << 23);
  } else {
    return 1.0f;
  }
}

// one pool element to the f32 of the bf16 the math uses: bf16 as is; int8
// and fp8 to f32, times the decoded scale, rounded to bf16 (the TPU
// kernel's order)
template <int MODE>
__device__ __forceinline__ float dequant(typename Elem<MODE>::T e, float s) {
  if constexpr (MODE == kBf16) {
    return __bfloat162float(e);
  } else if constexpr (MODE == kInt8) {
    return round_bf16(static_cast<float>(e) * s);
  } else {
    const __half_raw h = __nv_cvt_fp8_to_halfraw(e, __NV_E4M3);
    return round_bf16(__half2float(__half(h)) * s);
  }
}

// element j of kWarpTokens consecutive staged tokens held as 32-bit words
template <int MODE>
__device__ __forceinline__ typename Elem<MODE>::T word_elem(const uint32_t (&w)[4], int j) {
  if constexpr (MODE == kBf16) {
    __nv_bfloat16_raw r;
    r.x = static_cast<unsigned short>(w[j >> 1] >> (16 * (j & 1)));
    return __nv_bfloat16(r);
  } else {
    return static_cast<typename Elem<MODE>::T>(w[j >> 2] >> (8 * (j & 3)));
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The query heads an instantiation holds in registers, KG >= G: 4 or 16.
__host__ __device__ constexpr int heads_held(int G) { return G <= 4 ? 4 : kMaxG; }

// The chunks a group of G query heads (any G >= 1) goes in: the fewest
// that divide G into chunks of at most kMaxG heads (1 up to 16 heads; 2 at
// 32; 4 at 64; G chunks of one head when G is a prime over 16).
__host__ __device__ constexpr int head_split(int G) {
  int n = (G + kMaxG - 1) / kMaxG;
  while (G % n) ++n;
  return n;
}

// Shared memory of one block, offsets in floats, each 16-byte aligned: q
// (Dh, KG) f32, head-minor and zero past G, so a lane reads a head dim's
// KG values in KG / 4 16-byte loads; the warps' accumulators (8, G, Dh);
// the warps' bf16-rounded p (8, KG, 8); the warps' m and l (8, G, 2); the
// merged m and l (G, 2); the merge weights (64 splits or 8 warps, G); a
// flag; then kStages stages of a K slab and a V slab (Dh rows of
// kRowBytes) and the K and V scales.
struct Layout {
  int G, Dh;
  __host__ __device__ static size_t up4(size_t n) { return (n + 3) / 4 * 4; }
  __host__ __device__ size_t acc() const { return static_cast<size_t>(Dh) * heads_held(G); }
  __host__ __device__ size_t p() const { return acc() + up4(kWarps * static_cast<size_t>(G) * Dh); }
  __host__ __device__ size_t ml() const {
    return p() + static_cast<size_t>(kWarps) * heads_held(G) * kWarpTokens;
  }
  __host__ __device__ size_t mg() const { return ml() + up4(kWarps * G * 2); }
  __host__ __device__ size_t wt() const { return mg() + up4(G * 2); }
  __host__ __device__ size_t flag() const { return wt() + kMaxSplits * G; }
  __host__ __device__ size_t stage_off() const { return 4 * up4(flag() + 1); }  // bytes
  template <int MODE>
  __host__ __device__ size_t stage_bytes() const {
    return 2 * static_cast<size_t>(Dh) * kRowBytes<MODE> + 2 * kScaleBytes;
  }
  template <int MODE>
  __host__ __device__ size_t bytes() const {
    return stage_off() + kStages * stage_bytes<MODE>();
  }
};

// KG: the query heads the instantiation holds in registers, heads_held(G)
template <int MODE, int KG>
__global__ void __launch_bounds__(kThreads, KG == 4 ? 2 : 1) paged_decode_kernel(
    const __nv_bfloat16* __restrict__ q, const void* __restrict__ k_pool,
    const void* __restrict__ v_pool, const void* __restrict__ k_scale,
    const void* __restrict__ v_scale, const int32_t* __restrict__ table,
    const int32_t* __restrict__ lens, __nv_bfloat16* __restrict__ out,
    float* __restrict__ ws, int* __restrict__ counters, int H, int Hkv, int Dh, int page,
    int N, int P, int window, int span, int hsplit, float scale) {
  using T = typename Elem<MODE>::T;
  constexpr int kEsz = sizeof(T);
  constexpr int kVec = 16 / kEsz;  // elements a 16-byte copy
  constexpr int kRow = kRowBytes<MODE>;
  const int s = blockIdx.x;
  // the grid's kv-head axis runs the Hkv * hsplit chunks of the groups:
  // chunk kvh holds query heads [kvh * G, (kvh + 1) * G) of kv head
  // kvh / hsplit
  const int kvh = blockIdx.y;
  const int pool_kvh = kvh / hsplit;
  const int Hv = Hkv * hsplit;
  const int split = blockIdx.z;
  const int splits = gridDim.z;
  const int G = H / Hv;
  const int GD = G * Dh;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay{G, Dh};
  float* q_s = reinterpret_cast<float*>(smem);  // (Dh, KG)
  float* acc_s = q_s + lay.acc();               // (8, G, Dh)
  float* p_s = q_s + lay.p();                   // (8, KG, 8)
  float* ml_s = q_s + lay.ml();                 // (8, G, 2)
  float* mg_s = q_s + lay.mg();                 // (G, 2)
  float* wt_s = q_s + lay.wt();                 // (splits or 8, G)
  int* flag_s = reinterpret_cast<int*>(q_s + lay.flag());
  unsigned char* stages = smem + lay.stage_off();
  const size_t stage_bytes = lay.stage_bytes<MODE>();
  const size_t slab = static_cast<size_t>(Dh) * kRow;

  // this block's live positions: the slot's [lo, hi] inside the run. The
  // table entry of the run's first page is read beside len, not after it
  const int len = lens[s];
  const int run0 = split * span;
  const int first_page = min(run0 / page, P - 1);
  const int first_raw = table[static_cast<size_t>(s) * P + first_page];

  // q (S, H, Dh) and out (S, H, Dh): this group's heads are contiguous
  const size_t qo_base = (static_cast<size_t>(s) * H + static_cast<size_t>(kvh) * G) * Dh;
  for (int i = tid; i < Dh * KG; i += kThreads) {
    const int d = i / KG;
    const int g = i - d * KG;
    q_s[i] = g < G ? __bfloat162float(q[qo_base + g * Dh + d]) : 0.f;
  }
  for (int i = tid; i < kWarps * GD; i += kThreads) acc_s[i] = 0.f;

  const int run1 = run0 + span;  // one past the run
  const int lo = max(window > 0 ? max(len - window + 1, 0) : 0, run0);
  const int hi = min(min(len, P * page - 1), run1 - 1);

  const T* kp = static_cast<const T*>(k_pool);
  const T* vp = static_cast<const T*>(v_pool);
  // 16-byte copies need every chunk's rows to start on 16 bytes: the page a
  // multiple of kVec tokens and aligned pools (fp8 scales go 4 at a time)
  const bool vec = page % kVec == 0 && (reinterpret_cast<uintptr_t>(kp) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(vp) & 15) == 0 &&
                   (MODE != kFp8 || ((reinterpret_cast<uintptr_t>(k_scale) & 3) == 0 &&
                                     (reinterpret_cast<uintptr_t>(v_scale) & 3) == 0));
  // chunk [p, chunk_end(p)): at most kTile tokens, inside one page and the
  // run; every bound a multiple of kVec when vec (p starts on a multiple of 16)
  auto chunk_end = [&](int p) { return min(min(p + kTile, (p / page + 1) * page), run1); };
  auto page_id = [&](int p) {
    // a page id outside the pool (a table the allocator never wrote) is
    // clamped: the read stays inside the pool
    return static_cast<size_t>(min(max(table[static_cast<size_t>(s) * P + p / page], 0), N - 1));
  };

  // copy chunk [p, chunk_end(p)) of page `pid` into stage `st`
  auto issue = [&](int p, size_t pid, int st) {
    const int n = chunk_end(p) - p;
    const int off = p % page;
    const size_t head = pid * Hkv + pool_kvh;
    const size_t base = head * Dh * page + off;
    const size_t sbase = head * page + off;
    unsigned char* ks = stages + st * stage_bytes;
    unsigned char* vs = ks + slab;
    unsigned char* ksc = vs + slab;
    unsigned char* vsc = ksc + kScaleBytes;
    if (vec) {
      const int per_row = n / kVec;
      for (int c = tid; c < Dh * per_row; c += kThreads) {
        const int d = c / per_row;
        const int j = (c - d * per_row) * kVec;
        const size_t src = base + static_cast<size_t>(d) * page + j;
        cp_async16(ks + d * kRow + j * kEsz, kp + src);
        cp_async16(vs + d * kRow + j * kEsz, vp + src);
      }
      if constexpr (MODE == kInt8) {
        const float* kscl = static_cast<const float*>(k_scale);
        const float* vscl = static_cast<const float*>(v_scale);
        if (tid < n) cp_async4(ksc + 4 * tid, kscl + sbase + tid);
        const int tv = tid - kTile;
        if (tv >= 0 && tv < n) cp_async4(vsc + 4 * tv, vscl + sbase + tv);
      } else if constexpr (MODE == kFp8) {
        const uint8_t* kscl = static_cast<const uint8_t*>(k_scale);
        const uint8_t* vscl = static_cast<const uint8_t*>(v_scale);
        if (4 * tid < n) cp_async4(ksc + 4 * tid, kscl + sbase + 4 * tid);
        const int tv = tid - kTile;
        if (tv >= 0 && 4 * tv < n) cp_async4(vsc + 4 * tv, vscl + sbase + 4 * tv);
      }
    } else {
      T* kt = reinterpret_cast<T*>(ks);
      T* vt = reinterpret_cast<T*>(vs);
      for (int c = tid; c < Dh * n; c += kThreads) {
        const int d = c / n;
        const int j = c - d * n;
        const size_t src = base + static_cast<size_t>(d) * page + j;
        kt[d * (kRow / kEsz) + j] = kp[src];
        vt[d * (kRow / kEsz) + j] = vp[src];
      }
      if constexpr (MODE == kInt8) {
        if (tid < n) {
          reinterpret_cast<float*>(ksc)[tid] = static_cast<const float*>(k_scale)[sbase + tid];
          reinterpret_cast<float*>(vsc)[tid] = static_cast<const float*>(v_scale)[sbase + tid];
        }
      } else if constexpr (MODE == kFp8) {
        if (tid < n) {
          ksc[tid] = static_cast<const uint8_t*>(k_scale)[sbase + tid];
          vsc[tid] = static_cast<const uint8_t*>(v_scale)[sbase + tid];
        }
      }
    }
  };

  // this warp's online softmax state, the same in every lane
  float m_w[KG], l_w[KG];
#pragma unroll
  for (int g = 0; g < KG; ++g) {
    m_w[g] = kNegInf;
    l_w[g] = 0.f;
  }
  float* acc_w = acc_s + warp * GD;
  float* p_w = p_s + warp * KG * kWarpTokens;
  const int t = lane & (kWarpTokens - 1);  // this lane's token among the warp's 8
  const int quarter = lane / kWarpTokens;  // which head dims mod 4 it sums
  const int t0 = warp * kWarpTokens;       // the warp's tokens in a chunk

  if (len >= 0 && lo <= hi) {
    // the ring: chunks i + 1 and i + 2 in flight during chunk i's math
    int p_issue = lo & ~15;  // a multiple of 16 (and of kVec), inside the run
    int p_comp = p_issue;
    size_t pid = p_issue / page == first_page
                     ? static_cast<size_t>(min(max(first_raw, 0), N - 1))
                     : page_id(p_issue);
#pragma unroll
    for (int st = 0; st < kStages - 1; ++st) {
      if (p_issue <= hi) {
        issue(p_issue, pid, st);
        p_issue = chunk_end(p_issue);
        if (p_issue <= hi) pid = page_id(p_issue);  // read a chunk ahead
      }
      cp_async_commit();
    }
    int st = 0;
    while (p_comp <= hi) {
      cp_async_wait<kStages - 2>();
      __syncthreads();  // chunk p_comp is in; every warp is past the last one
      if (p_issue <= hi) {
        issue(p_issue, pid, st == 0 ? kStages - 1 : st - 1);
        p_issue = chunk_end(p_issue);
        if (p_issue <= hi) pid = page_id(p_issue);
      }
      cp_async_commit();
      const int p0 = p_comp;
      p_comp = chunk_end(p0);
      // this warp's live tokens of the chunk: t in [a, b]
      const int a = max(lo - p0 - t0, 0);
      const int b = min(min(hi, p_comp - 1) - p0 - t0, kWarpTokens - 1);
      const unsigned char* ks = stages + st * stage_bytes;
      const unsigned char* vs = ks + slab;
      const unsigned char* ksc = vs + slab;
      const unsigned char* vsc = ksc + kScaleBytes;
      st = st == kStages - 1 ? 0 : st + 1;
      if (a > b) continue;  // warp-uniform: nothing of this chunk is the warp's
      const bool live = t >= a && t <= b;

      // scores: this lane's token, the head dims of its quarter (d % 4),
      // every head (zero q past G)
      float sc[KG];
#pragma unroll
      for (int g = 0; g < KG; ++g) sc[g] = 0.f;
      const float kscl = scale_at<MODE>(ksc, t0 + t);
      const T* kcol = reinterpret_cast<const T*>(ks) + t0 + t;
#pragma unroll 4
      for (int d = quarter; d < Dh; d += 4) {
        const float kv = dequant<MODE>(kcol[d * (kRow / kEsz)], kscl);
        const float4* qd = reinterpret_cast<const float4*>(q_s + d * KG);
#pragma unroll
        for (int c = 0; c < KG / 4; ++c) {
          const float4 q4 = qd[c];
          sc[4 * c] = fmaf(q4.x, kv, sc[4 * c]);
          sc[4 * c + 1] = fmaf(q4.y, kv, sc[4 * c + 1]);
          sc[4 * c + 2] = fmaf(q4.z, kv, sc[4 * c + 2]);
          sc[4 * c + 3] = fmaf(q4.w, kv, sc[4 * c + 3]);
        }
      }

      // online softmax over the warp's 8 tokens, every head at once so the
      // heads' shuffles overlap; the four quarters' sums meet in a
      // butterfly, the same bits in every lane
      float x[KG], red[KG], alpha[KG];
#pragma unroll
      for (int g = 0; g < KG; ++g) red[g] = sc[g] + __shfl_xor_sync(0xffffffffu, sc[g], 8);
#pragma unroll
      for (int g = 0; g < KG; ++g) {
        x[g] = red[g] + __shfl_xor_sync(0xffffffffu, red[g], 16);
        if (MODE == kBf16) x[g] = round_bf16(x[g]);
        x[g] = live ? x[g] * scale : kNegInf;
        red[g] = x[g];
      }
#pragma unroll
      for (int o = kWarpTokens / 2; o > 0; o >>= 1)
#pragma unroll
        for (int g = 0; g < KG; ++g) red[g] = fmaxf(red[g], __shfl_xor_sync(0xffffffffu, red[g], o));
#pragma unroll
      for (int g = 0; g < KG; ++g) {
        const float m_new = fmaxf(m_w[g], red[g]);
        alpha[g] = expf(fminf(m_w[g] - m_new, 0.f));
        m_w[g] = m_new;
        float p = expf(x[g] - m_new);
        if (x[g] <= kNegInf * 0.5f) p = 0.f;
        x[g] = p;
        red[g] = p;
      }
#pragma unroll
      for (int o = kWarpTokens / 2; o > 0; o >>= 1)
#pragma unroll
        for (int g = 0; g < KG; ++g) red[g] += __shfl_xor_sync(0xffffffffu, red[g], o);
#pragma unroll
      for (int g = 0; g < KG; ++g) {
        l_w[g] = l_w[g] * alpha[g] + red[g];
        if (quarter == 0) p_w[g * kWarpTokens + t] = round_bf16(x[g]);
      }
      __syncwarp();

      // PV: head dims lane, lane + 32, ...; 8 products an output. Every
      // load of a head dim's outputs comes before its stores
      float vscl[kWarpTokens];
#pragma unroll
      for (int j = 0; j < kWarpTokens; ++j) vscl[j] = scale_at<MODE>(vsc, t0 + j);
      for (int d = lane; d < Dh; d += 32) {
        const unsigned char* vrow = vs + d * kRow + t0 * kEsz;
        uint32_t w[4];
        if constexpr (MODE == kBf16) {
          const uint4 r = *reinterpret_cast<const uint4*>(vrow);
          w[0] = r.x;
          w[1] = r.y;
          w[2] = r.z;
          w[3] = r.w;
        } else {
          const uint2 r = *reinterpret_cast<const uint2*>(vrow);
          w[0] = r.x;
          w[1] = r.y;
        }
        float vv[kWarpTokens];
#pragma unroll
        for (int j = 0; j < kWarpTokens; ++j) {
          // a token outside [a, b] has p = 0; its value, whatever the pool
          // holds there, never meets it
          vv[j] = j >= a && j <= b ? dequant<MODE>(word_elem<MODE>(w, j), vscl[j]) : 0.f;
        }
        float acc[KG], pv[KG];
#pragma unroll
        for (int g = 0; g < KG; ++g) {
          acc[g] = g < G ? acc_w[g * Dh + d] : 0.f;
          const float4* pr = reinterpret_cast<const float4*>(p_w + g * kWarpTokens);
          pv[g] = 0.f;
#pragma unroll
          for (int c = 0; c < kWarpTokens / 4; ++c) {
            const float4 p4 = pr[c];
            pv[g] = fmaf(p4.x, vv[4 * c], pv[g]);
            pv[g] = fmaf(p4.y, vv[4 * c + 1], pv[g]);
            pv[g] = fmaf(p4.z, vv[4 * c + 2], pv[g]);
            pv[g] = fmaf(p4.w, vv[4 * c + 3], pv[g]);
          }
        }
#pragma unroll
        for (int g = 0; g < KG; ++g) {
          if (g < G) acc_w[g * Dh + d] = acc[g] * alpha[g] + pv[g];
        }
      }
      __syncwarp();  // p_w is read before the next chunk writes it
    }
    cp_async_wait<0>();
  }

  // merge the four warps in warp order
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < KG; ++g) {
      if (g < G) {
        ml_s[(warp * G + g) * 2] = m_w[g];
        ml_s[(warp * G + g) * 2 + 1] = l_w[g];
      }
    }
  }
  __syncthreads();
  if (tid < G) {
    float m = kNegInf;
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, ml_s[(w * G + tid) * 2]);
    float l = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float wt = expf(ml_s[(w * G + tid) * 2] - m);
      l += ml_s[(w * G + tid) * 2 + 1] * wt;
      wt_s[w * G + tid] = wt;
    }
    mg_s[2 * tid] = m;
    mg_s[2 * tid + 1] = l;
  }
  __syncthreads();
  const size_t part = static_cast<size_t>(GD) + 2 * G;  // floats of one partial
  float* my_part =
      splits == 1 ? nullptr
                  : ws + ((static_cast<size_t>(s) * Hv + kvh) * splits + split) * part;
  for (int o = tid; o < GD; o += kThreads) {
    const int g = o / Dh;
    float acc = 0.f;
    for (int w = 0; w < kWarps; ++w) acc += acc_s[w * GD + o] * wt_s[w * G + g];
    if (splits == 1) {
      out[qo_base + o] = __float2bfloat16_rn(acc / fmaxf(mg_s[2 * g + 1], 1e-37f));
    } else {
      my_part[o] = acc;
    }
  }
  if (splits == 1) return;
  if (tid < 2 * G) my_part[GD + tid] = mg_s[tid];

  // the last block of this (slot, kv head) merges the splits
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* counter = counters + static_cast<size_t>(s) * Hv + kvh;
    const int ticket = atomicAdd(counter, 1);
    const bool last = ticket == splits - 1;
    if (last) *counter = 0;  // every split has drawn: ready for the next launch
    *flag_s = last;
  }
  __syncthreads();
  if (!*flag_s) return;
  __threadfence();
  const float* parts = ws + (static_cast<size_t>(s) * Hv + kvh) * splits * part;
  if (tid < G) {
    float m = kNegInf;
#pragma unroll 8
    for (int j = 0; j < splits; ++j) m = fmaxf(m, __ldcg(parts + j * part + GD + 2 * tid));
    float l = 0.f;
#pragma unroll 8
    for (int j = 0; j < splits; ++j) {
      const float wt = expf(__ldcg(parts + j * part + GD + 2 * tid) - m);
      l += __ldcg(parts + j * part + GD + 2 * tid + 1) * wt;
      wt_s[j * G + tid] = wt;
    }
    mg_s[2 * tid + 1] = l;
  }
  __syncthreads();
  for (int o = tid; o < GD; o += kThreads) {
    const int g = o / Dh;
    float acc = 0.f;
#pragma unroll 8
    for (int j = 0; j < splits; ++j) acc += __ldcg(parts + j * part + o) * wt_s[j * G + g];
    out[qo_base + o] = __float2bfloat16_rn(acc / fmaxf(mg_s[2 * g + 1], 1e-37f));
  }
}

struct Args {
  const void *q, *k_pool, *v_pool, *k_scale, *v_scale, *table, *lens;
  void *out, *ws, *counters;
  int S, H, Hkv, Dh, page, N, P, window, splits, span, hsplit;
  float scale;
  cudaStream_t stream;
};

template <int MODE, int KG>
cudaError_t launch_g(const Args& a, size_t smem) {
  const cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<MODE, KG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(a.S, a.Hkv * a.hsplit, a.splits);
  paged_decode_kernel<MODE, KG><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), a.k_pool, a.v_pool, a.k_scale, a.v_scale,
      static_cast<const int32_t*>(a.table), static_cast<const int32_t*>(a.lens),
      static_cast<__nv_bfloat16*>(a.out), static_cast<float*>(a.ws),
      static_cast<int*>(a.counters), a.H, a.Hkv, a.Dh, a.page, a.N, a.P, a.window, a.span,
      a.hsplit, a.scale);
  return cudaGetLastError();
}

// the instantiation that holds a chunk's heads: 4 or 16 of them in registers
template <int MODE>
cudaError_t launch(const Args& a, size_t smem) {
  return heads_held(a.H / (a.Hkv * a.hsplit)) == 4 ? launch_g<MODE, 4>(a, smem)
                                                   : launch_g<MODE, kMaxG>(a, smem);
}

template <int MODE, int KG>
int resources_g(size_t smem, int* out) {
  cudaFuncAttributes attr;
  int blocks = 0;
  cudaError_t err = cudaFuncGetAttributes(&attr, paged_decode_kernel<MODE, KG>);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(paged_decode_kernel<MODE, KG>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, paged_decode_kernel<MODE, KG>,
                                                        kThreads, smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(smem);
  out[3] = blocks;
  return 0;
}

template <int MODE>
int resources(int G, size_t smem, int* out) {
  return heads_held(G) == 4 ? resources_g<MODE, 4>(smem, out)
                            : resources_g<MODE, kMaxG>(smem, out);
}

}  // namespace

extern "C" {

// Shared memory one block needs for pools of `mode` (0 bf16, 1 int8, 2
// fp8), in bytes: a block holds one chunk of its group's heads (0 for a
// refused shape).
size_t paged_decode_smem_bytes(int H, int Hkv, int Dh, int mode) {
  if (Hkv < 1 || H < Hkv || H % Hkv || Dh < 1) return 0;
  const int G = H / Hkv;
  const Layout lay{G / head_split(G), Dh};
  switch (mode) {
    case kBf16: return lay.bytes<kBf16>();
    case kInt8: return lay.bytes<kInt8>();
    case kFp8: return lay.bytes<kFp8>();
    default: return 0;
  }
}

// The chunks a kv head's H / Hkv query heads run in, a block each
// (head_split; 1 for a group of at most 16), or 0 for a refused shape.
int paged_decode_head_chunks(int H, int Hkv) {
  if (Hkv < 1 || H < Hkv || H % Hkv) return 0;
  return head_split(H / Hkv);
}

// mode: 0 bf16 pools, 1 int8 pools with f32 scales, 2 fp8 e4m3 pools with
// uint8 E8M0 scales. window <= 0 means none. The grid is (S, Hkv, splits);
// split j reads the table positions [j * span, (j + 1) * span), span a
// multiple of 64 with splits * span >= P * page; a group of more than 16
// query heads runs in head_split(G) chunks along the kv-head axis. With
// splits > 1, ws holds S * Hkv * splits * G * (Dh + 2) f32 and counters
// S * Hkv * head_split(G) int32 zeros (left zero by the launch); with one
// split both may be null. Returns
// cudaGetLastError() (or cudaErrorInvalidValue for a refused shape).
int paged_decode_launch(const void* q, const void* k_pool, const void* v_pool,
                        const void* k_scale, const void* v_scale, const void* table,
                        const void* lens, void* out, void* ws, void* counters, int S, int H,
                        int Hkv, int Dh, int page, int N, int P, int window, int splits,
                        int span, int mode, float scale, void* stream) {
  const size_t smem = paged_decode_smem_bytes(H, Hkv, Dh, mode);
  if (smem == 0 || smem > 227 * 1024 || page < 1 || N < 1 || P < 1 || splits < 1 ||
      splits > kMaxSplits || splits > 65535 || span < kTile || span % kTile ||
      static_cast<long long>(splits) * span < static_cast<long long>(P) * page ||
      static_cast<long long>(splits) * span > (1LL << 30) ||
      Hkv * head_split(H / Hkv) > 65535 ||
      (splits > 1 && (ws == nullptr || counters == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (S == 0) return 0;
  const Args a{q, k_pool, v_pool, k_scale, v_scale, table, lens, out, ws, counters, S, H,
               Hkv, Dh, page, N, P, window, splits, span, head_split(H / Hkv), scale,
               static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  switch (mode) {
    case kBf16: err = launch<kBf16>(a, smem); break;
    case kInt8: err = launch<kInt8>(a, smem); break;
    case kFp8: err = launch<kFp8>(a, smem); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// What the kernel for pools of `mode` takes on this card at H query heads
// over Hkv kv heads of width Dh (the instantiation for a chunk of G = H /
// Hkv heads): out[0] registers a thread, out[1] local
// (spilled) bytes a thread, out[2] dynamic shared memory a block, out[3]
// resident blocks an SM. Returns a CUDA error code, 0 on success.
int paged_decode_resources(int mode, int H, int Hkv, int Dh, int* out) {
  const size_t smem = paged_decode_smem_bytes(H, Hkv, Dh, mode);
  if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (mode) {
    case kBf16: return resources<kBf16>(H / Hkv / head_split(H / Hkv), smem, out);
    case kInt8: return resources<kInt8>(H / Hkv / head_split(H / Hkv), smem, out);
    case kFp8: return resources<kFp8>(H / Hkv / head_split(H / Hkv), smem, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
