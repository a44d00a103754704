// Per-status telemetry aggregation for Hopper (sm_90a), bound through a
// plain C interface (ctypes) by beholder_tpu_torch/ops/fused_aggregate.py.
//
// Replaces the TPU kernel beholder_tpu/ops/pallas_aggregate.py::_kernel
// (launched by _run, public as aggregate_telemetry_pallas). One launch
// computes the whole of aggregate_telemetry for a batch of n events: per
// status s in [0, S), the count (int32), and the mean, max and min of
// progress (f32), with mean, max and min 0 where the count is 0. Statuses
// outside [0, S) contribute nothing.
//
// What bounds it: bytes. Each event is read once (4 bytes of status, 4 of
// progress): 8,388,608 events are 67.1 MB, 20.0 us at 3.35 TB/s. At the
// sink's flush of 4,096 events (32 KB) the bound is 10 ns, and what counts
// is the chain of dependent steps from launch to the last store.
//
// What the design does about it:
// - One device operation a call. The scratch (a ticket and the per-block
//   partials) is the wrapper's buffer per (device, stream), zeroed once
//   when made; the block that combines resets the ticket to 0 before it
//   exits, so every launch leaves the buffer as it found it and no memset
//   precedes a launch.
// - Two paths, chosen on the host from n alone (fused_aggregate.py
//   aggregate_plan). Up to 16,384 events one block reads the whole batch,
//   reduces in shared memory and writes the outputs: no ticket, no
//   partials, no second pass through L2. Above it a persistent grid of 2
//   blocks an SM (at most) walks the batch in rounds, each block writes
//   one partial, and the last block to take the ticket (after
//   __threadfence()) combines them.
// - Loads in flight during the math: register double-buffering. A thread
//   issues the next round's 16-byte loads (2 of status, 2 of progress)
//   before it does this round's 8 events, so 64 bytes a thread, 64 KB an SM
//   at 1,024 threads, stay in flight while it computes (Little's law wants
//   ~25 KB an SM at ~1 us of DRAM latency). Chosen over a TMA or cp.async
//   ring: the loads are already coalesced 16-byte loads of two plain
//   streams, a round is small enough to sit in registers, and a ring would
//   add an mbarrier handshake a stage and shared memory that the records
//   below need, for nothing the registers do not already give.
// - Fewer issue slots an event. Each thread owns one 16-byte record
//   (count, sum, max, min) per status in shared memory, at
//   records[status][threadIdx.x]: an event is an unsigned range check, one
//   128-bit shared load, an integer add, an f32 add, a max, a min and one
//   128-bit shared store (plus the int32 -> f32 conversion), where the
//   first design ran an unrolled compare-and-select over all six statuses
//   in registers. Each thread owns its column, so the bank pattern does not
//   depend on the statuses (any mix costs what a uniform warp costs) and
//   nothing is atomic. The compiler cannot prove two events' statuses
//   differ, so a thread's events chain through shared memory in order
//   whatever the mix: a skewed stream costs what a uniform one does.
//   SASS of the vector loop (cuobjdump -sass, sm_90a): 130 instructions
//   for a round's 8 events with int32 progress, 16.3 an event (f32
//   progress: 122, 15.3), 9 of them the event's own and the rest the loads
//   and their addresses; the first design's loop took 415 for 8 events,
//   51.9 an event (f32: 407, 50.9).
// - The unaligned head, the ragged tail, and batches whose two pointers
//   share no 16-byte offset go one event at a time (four loads ahead a
//   thread), spread over the grid.
// - Results are deterministic: per thread an f32 sum in event order, per
//   status one warp combines a block's 512 records in a fixed order with
//   f64 sums, and the last block combines the partials in an order fixed
//   by the grid alone, sums in f64. No float atomics, no per-event atomics.
//   Counts are int32. Initial max/min are the reference's -1e9 / +1e9.
//
// Output: a (4, S) buffer of 32-bit words, row 0 the int32 counts, rows
// 1-3 the f32 mean, max and min. Scratch (persistent path only): word 0 the
// ticket, words 1-3 padding, then f64 sums [S][grid], then u32 counts,
// maxes and mins [S][grid] each: 4 + 5 S grid words.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kS = 6;                  // statuses (QUEUED..ERRORED)
constexpr int kThreads = 512;
constexpr int kBlocksPerSM = 2;
constexpr int kUnroll = 2;             // 16-byte loads of each input a thread, a round
constexpr int kRound = kUnroll * kThreads;  // int4 groups a round: 4,096 events
constexpr int kScratchHead = 4;        // words before the partials
constexpr int kPartialWords = 5 * kS;  // f64 sum (2 words), count, max, min a status
constexpr size_t kSmemBytes = sizeof(float4) * kS * kThreads;  // 48 KB of records
// the most blocks whose partials the last block stages in the records' space
constexpr int kMaxGrid = static_cast<int>(kSmemBytes / (kS * (sizeof(double) + 12)));
constexpr float kBig = 1e9f;

template <bool kF32>
__device__ __forceinline__ float prog(int bits) {
  return kF32 ? __int_as_float(bits) : static_cast<float>(bits);
}

// 16 bytes read once: not kept in L1, L2 asked to fetch 256-byte sectors
__device__ __forceinline__ int4 ld_stream(const int4* p) {
  int4 v;
  asm("ld.global.nc.L1::no_allocate.L2::256B.v4.s32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// One event into this thread's record of its status (`mine` is the
// thread's column: record s at mine[s * kThreads]).
template <bool kF32>
__device__ __forceinline__ void add(float4* mine, int status, int bits) {
  if (static_cast<unsigned int>(status) < static_cast<unsigned int>(kS)) {
    float4* r = mine + status * kThreads;
    float4 a = *r;
    const float p = prog<kF32>(bits);
    a.x = __int_as_float(__float_as_int(a.x) + 1);
    a.y += p;
    a.z = fmaxf(a.z, p);
    a.w = fminf(a.w, p);
    *r = a;
  }
}

template <bool kF32>
__device__ __forceinline__ void add4(float4* mine, const int4& s, const int4& p) {
  add<kF32>(mine, s.x, p.x);
  add<kF32>(mine, s.y, p.y);
  add<kF32>(mine, s.z, p.z);
  add<kF32>(mine, s.w, p.w);
}

// Round r's groups of this thread; past the body a group is 4 statuses -1
// (they count for nothing) and no load is made.
__device__ __forceinline__ void load_round(const int4* s4, const int4* p4, long long nvec,
                                           long long r, int4 (&s)[kUnroll],
                                           int4 (&p)[kUnroll]) {
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const long long g = r * kRound + k * kThreads + threadIdx.x;
    if (g < nvec) {
      s[k] = ld_stream(s4 + g);
      p[k] = ld_stream(p4 + g);
    } else {
      s[k] = make_int4(-1, -1, -1, -1);
      p[k] = make_int4(0, 0, 0, 0);
    }
  }
}

struct Stat {
  int cnt;
  double sum;
  float hi;
  float lo;
};

// A fixed xor tree over the warp: every lane ends with the same bits.
__device__ __forceinline__ void warp_combine(Stat& a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a.cnt += __shfl_xor_sync(0xffffffffu, a.cnt, off);
    a.sum += __shfl_xor_sync(0xffffffffu, a.sum, off);
    a.hi = fmaxf(a.hi, __shfl_xor_sync(0xffffffffu, a.hi, off));
    a.lo = fminf(a.lo, __shfl_xor_sync(0xffffffffu, a.lo, off));
  }
}

__device__ __forceinline__ void write_out(unsigned int* out, int s, const Stat& a) {
  const bool present = a.cnt > 0;
  out[s] = static_cast<unsigned int>(a.cnt);
  out[kS + s] = __float_as_uint(
      present ? static_cast<float>(a.sum) / static_cast<float>(a.cnt) : 0.f);
  out[2 * kS + s] = __float_as_uint(present ? a.hi : 0.f);
  out[3 * kS + s] = __float_as_uint(present ? a.lo : 0.f);
}

// Events [0, head) and [head + 4 nvec, n) one at a time; the nvec int4
// groups from `head` in rounds of kRound, round r taken by block
// r mod gridDim.x. kOneBlock: a grid of one block that writes the outputs.
template <bool kF32, bool kOneBlock>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
aggregate_kernel(const int* __restrict__ status, const int* __restrict__ progress,
                 long long n, long long head, long long nvec,
                 unsigned int* __restrict__ scratch, unsigned int* __restrict__ out) {
  extern __shared__ float4 records[];  // [kS][kThreads]
  float4* mine = records + threadIdx.x;
#pragma unroll
  for (int s = 0; s < kS; ++s) mine[s * kThreads] = make_float4(0.f, 0.f, -kBig, kBig);

  // the body: this round's 8 events while the next round's loads fly
  const int4* s4 = reinterpret_cast<const int4*>(status + head);
  const int4* p4 = reinterpret_cast<const int4*>(progress + head);
  const long long rounds = (nvec + kRound - 1) / kRound;
  int4 cs[kUnroll], cp[kUnroll];
  load_round(s4, p4, nvec, blockIdx.x, cs, cp);
  for (long long r = blockIdx.x; r < rounds; r += gridDim.x) {
    int4 ns[kUnroll], np[kUnroll];
    load_round(s4, p4, nvec, r + gridDim.x, ns, np);
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      add4<kF32>(mine, cs[k], cp[k]);
      cs[k] = ns[k];
      cp[k] = np[k];
    }
  }

  // the element path: element j < head is event j, the others the tail's
  const long long tail0 = head + 4 * nvec;
  const long long rest = head + (n - tail0);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long j = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; j < rest;
       j += 4 * stride) {
    int s[4], p[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const long long jj = j + k * stride;
      const long long i = jj < head ? jj : tail0 + (jj - head);
      s[k] = jj < rest ? __ldg(status + i) : -1;
      p[k] = jj < rest ? __ldg(progress + i) : 0;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) add<kF32>(mine, s[k], p[k]);
  }
  __syncthreads();

  // the block's partial: warp s < kS combines status s's records, lane l
  // taking threads l, l + 32, ... in order
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Stat a{0, 0.0, -kBig, kBig};
  if (warp < kS) {
    const float4* row = records + warp * kThreads;
#pragma unroll 4
    for (int k = 0; k < kThreads / 32; ++k) {
      const float4 r = row[k * 32 + lane];
      a.cnt += __float_as_int(r.x);
      a.sum += static_cast<double>(r.y);
      a.hi = fmaxf(a.hi, r.z);
      a.lo = fminf(a.lo, r.w);
    }
    warp_combine(a);
  }
  if constexpr (kOneBlock) {
    if (warp < kS && lane == 0) write_out(out, warp, a);
    return;
  } else {
    const unsigned int grid = gridDim.x;
    unsigned int* ticket = scratch;
    double* psum = reinterpret_cast<double*>(scratch + kScratchHead);
    unsigned int* pcnt = scratch + kScratchHead + 2 * kS * grid;
    unsigned int* phi = pcnt + kS * grid;
    unsigned int* plo = phi + kS * grid;
    if (warp < kS && lane == 0) {
      const unsigned int i = warp * grid + blockIdx.x;
      psum[i] = a.sum;
      pcnt[i] = static_cast<unsigned int>(a.cnt);
      phi[i] = __float_as_uint(a.hi);
      plo[i] = __float_as_uint(a.lo);
      __threadfence();
    }
    __shared__ bool is_last;
    __syncthreads();
    if (threadIdx.x == 0) is_last = atomicAdd(ticket, 1u) == grid - 1;
    __syncthreads();
    if (!is_last) return;

    // the last block: every partial is visible. Thread b brings block b's
    // partials from L2 into the records' shared memory (one round trip for
    // the whole grid); then warp s combines status s, lane l taking blocks
    // l, l + 32, ... in order, then the same xor tree.
    __threadfence();
    double* ssum = reinterpret_cast<double*>(records);  // [kS][grid], then
    unsigned int* scnt = reinterpret_cast<unsigned int*>(ssum + kS * grid);  // u32 [3][kS][grid]
    for (unsigned int b = threadIdx.x; b < grid; b += kThreads) {
#pragma unroll
      for (int s = 0; s < kS; ++s) {
        const unsigned int i = s * grid + b;
        ssum[i] = __ldcg(psum + i);
        scnt[i] = __ldcg(pcnt + i);
        scnt[kS * grid + i] = __ldcg(phi + i);
        scnt[2 * kS * grid + i] = __ldcg(plo + i);
      }
    }
    __syncthreads();
    if (warp < kS) {
      Stat t{0, 0.0, -kBig, kBig};
      for (unsigned int b = lane; b < grid; b += 32) {
        const unsigned int i = warp * grid + b;
        t.cnt += static_cast<int>(scnt[i]);
        t.sum += ssum[i];
        t.hi = fmaxf(t.hi, __uint_as_float(scnt[kS * grid + i]));
        t.lo = fminf(t.lo, __uint_as_float(scnt[2 * kS * grid + i]));
      }
      warp_combine(t);
      if (lane == 0) write_out(out, warp, t);
    }
    if (threadIdx.x == 0) *ticket = 0;  // the buffer as the launch found it
  }
}

// The records' 48 KB need the opt-in above the default 48 KB a block (with
// the static flag beside them): set once per device and instantiation.
template <bool kF32, bool kOneBlock>
cudaError_t opt_in() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (bit != 0 && (done.load(std::memory_order_relaxed) & bit)) return cudaSuccess;
  err = cudaFuncSetAttribute(aggregate_kernel<kF32, kOneBlock>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemBytes));
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

template <bool kF32, bool kOneBlock>
int launch(const int* s, const int* p, long long n, long long head, long long nvec, int grid,
           unsigned int* scratch, unsigned int* out, cudaStream_t st) {
  const cudaError_t err = opt_in<kF32, kOneBlock>();
  if (err != cudaSuccess) return static_cast<int>(err);
  aggregate_kernel<kF32, kOneBlock><<<grid, kThreads, kSmemBytes, st>>>(s, p, n, head, nvec,
                                                                       scratch, out);
  return static_cast<int>(cudaGetLastError());
}

template <bool kF32, bool kOneBlock>
int resources(int* out) {
  cudaFuncAttributes attr;
  int blocks = 0;
  cudaError_t err = cudaFuncGetAttributes(&attr, aggregate_kernel<kF32, kOneBlock>);
  if (err == cudaSuccess) err = opt_in<kF32, kOneBlock>();
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, aggregate_kernel<kF32, kOneBlock>,
                                                        kThreads, kSmemBytes);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(attr.sharedSizeBytes + kSmemBytes);
  out[3] = blocks;
  return 0;
}

}  // namespace

extern "C" {

// status: n int32; progress: n int32 (progress_f32 = 0) or f32 (1); both
// 4-byte aligned. head + 4 nvec <= n, and with nvec > 0 both pointers
// advanced by head elements are 16-byte aligned. num_statuses must be the
// S built in. one_block: grid 1, the outputs written by that block, scratch
// unused. Otherwise scratch holds scratch_words >= 4 + 5 S grid words whose
// first word is 0 (the launch leaves it 0). out: 4 x S words. Returns
// cudaGetLastError() (cudaErrorInvalidValue on what the kernel does not
// take: a grid of more than 409 blocks among it).
int aggregate_launch(const void* status, const void* progress, long long n, long long head,
                     long long nvec, int progress_f32, int num_statuses, int grid,
                     int one_block, void* scratch, long long scratch_words, void* out,
                     void* stream) {
  const uintptr_t sa = reinterpret_cast<uintptr_t>(status);
  const uintptr_t pa = reinterpret_cast<uintptr_t>(progress);
  const bool body_aligned =
      nvec == 0 || (((sa + 4 * head) & 15) == 0 && ((pa + 4 * head) & 15) == 0);
  if (n < 1 || num_statuses != kS || grid < 1 || grid > kMaxGrid || (sa & 3) || (pa & 3) ||
      head < 0 || nvec < 0 || head + 4 * nvec > n || !body_aligned || out == nullptr ||
      (one_block && grid != 1) ||
      (!one_block && (scratch == nullptr ||
                      scratch_words < kScratchHead + static_cast<long long>(kPartialWords) *
                                                         grid))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* s = static_cast<const int*>(status);
  const int* p = static_cast<const int*>(progress);
  unsigned int* sc = static_cast<unsigned int*>(scratch);
  unsigned int* o = static_cast<unsigned int*>(out);
  if (progress_f32) {
    return one_block ? launch<true, true>(s, p, n, head, nvec, grid, sc, o, st)
                     : launch<true, false>(s, p, n, head, nvec, grid, sc, o, st);
  }
  return one_block ? launch<false, true>(s, p, n, head, nvec, grid, sc, o, st)
                   : launch<false, false>(s, p, n, head, nvec, grid, sc, o, st);
}

// Registers, local bytes, shared memory a block (static and dynamic) and
// resident blocks an SM of one instantiation: which bit 0 f32 progress,
// bit 1 the one-block path. out: 4 ints. Returns a CUDA error code.
int aggregate_resources(int which, int* out) {
  switch (which) {
    case 0: return resources<false, false>(out);
    case 1: return resources<true, false>(out);
    case 2: return resources<false, true>(out);
    case 3: return resources<true, true>(out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
