// Per-status telemetry aggregation for Hopper (sm_90a), bound through a
// plain C interface (ctypes) by beholder_tpu_torch/ops/fused_aggregate.py.
//
// Replaces the TPU kernel beholder_tpu/ops/pallas_aggregate.py::_kernel
// (launched by _run, public as aggregate_telemetry_pallas). One launch
// computes the whole of aggregate_telemetry for a batch of B events: per
// status s in [0, S), the count (int32), and the mean, max and min of
// progress (f32), with mean, max and min 0 where the count is 0. Statuses
// outside [0, S) contribute nothing.
//
// What bounds it: bytes. Each event is read once (4 bytes of status, 4 of
// progress) and the work per event is a few integer and f32 operations per
// status, far below the card's rate: 8,388,608 events are 67.1 MB, 20 us
// at 3.35 TB/s.
//
// What the design does about it:
// - One pass over the batch in place. The TPU kernel's sequential grid
//   carried the accumulators in one resident output block; here a fixed
//   grid strides over the batch, each thread keeps 4 x S accumulators in
//   registers (the status loop is unrolled with selects: a register array
//   indexed by a dynamic status would spill to local memory), and loads 16
//   bytes of each input at a time where both pointers share their offset
//   within 16 bytes. The unaligned head and the ragged tail go one event a
//   thread: no padded copy of the batch (the TPU path pads with status -1).
//   int32 progress is converted here, so an int32 batch needs no cast pass.
// - A warp shuffle and one pass through shared memory reduce each block to
//   one partial in a scratch buffer; the last block to finish (an atomic
//   ticket taken after __threadfence()) combines the partials, one warp per
//   field, each lane over a fixed set of blocks, the sums in f64, and
//   writes the outputs. No float atomics, no per-event atomics: the result
//   is the same bit for bit from run to run, and a skewed stream (most
//   events in one status) serialises nothing.
// - Counts are int32 (the Pallas kernel counts in f32 per lane, exact only
//   to 2^24 events). Initial max/min are the reference's -1e9 / +1e9.
//
// Output: a (4, S) buffer of 32-bit words, row 0 the int32 counts, rows
// 1-3 the f32 mean, max and min. Scratch: word 0 the ticket (cleared on the
// stream before the launch), then 4 x S words per block, field-major.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kS = 6;                 // statuses (QUEUED..ERRORED)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFields = 4 * kS;       // counts, sums, maxes, mins
constexpr float kBig = 1e9f;

struct Acc {
  int cnt[kS];
  float sum[kS];
  float hi[kS];
  float lo[kS];
};

template <bool kF32>
__device__ __forceinline__ float prog(int bits) {
  return kF32 ? __int_as_float(bits) : static_cast<float>(bits);
}

__device__ __forceinline__ void add(Acc& a, int status, float p) {
#pragma unroll
  for (int s = 0; s < kS; ++s) {
    const bool m = status == s;
    a.cnt[s] += m ? 1 : 0;
    a.sum[s] += m ? p : 0.f;
    a.hi[s] = m ? fmaxf(a.hi[s], p) : a.hi[s];
    a.lo[s] = m ? fminf(a.lo[s], p) : a.lo[s];
  }
}

template <bool kF32>
__device__ __forceinline__ void add4(Acc& a, const int4& s, const int4& p) {
  add(a, s.x, prog<kF32>(p.x));
  add(a, s.y, prog<kF32>(p.y));
  add(a, s.z, prog<kF32>(p.z));
  add(a, s.w, prog<kF32>(p.w));
}

// kind 0: int32 add on the words' bits; 1: f32 add; 2: max; 3: min
__device__ __forceinline__ float combine(int kind, float x, float y) {
  switch (kind) {
    case 0: return __int_as_float(__float_as_int(x) + __float_as_int(y));
    case 1: return x + y;
    case 2: return fmaxf(x, y);
    default: return fminf(x, y);
  }
}

// Events [0, head) and [head + 4 nvec, n) one at a time; the nvec int4
// groups from `head` 16 bytes at a time.
template <bool kF32>
__global__ void __launch_bounds__(kThreads, 2)
aggregate_kernel(const int* __restrict__ status, const int* __restrict__ progress,
                 long long n, long long head, long long nvec,
                 unsigned int* __restrict__ scratch, unsigned int* __restrict__ out) {
  Acc a;
#pragma unroll
  for (int s = 0; s < kS; ++s) {
    a.cnt[s] = 0;
    a.sum[s] = 0.f;
    a.hi[s] = -kBig;
    a.lo[s] = kBig;
  }
  const long long tid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;

  const int4* s4 = reinterpret_cast<const int4*>(status + head);
  const int4* p4 = reinterpret_cast<const int4*>(progress + head);
  long long v = tid;
  for (; v + stride < nvec; v += 2 * stride) {  // two groups in flight
    const int4 s0 = __ldg(s4 + v), p0 = __ldg(p4 + v);
    const int4 s1 = __ldg(s4 + v + stride), p1 = __ldg(p4 + v + stride);
    add4<kF32>(a, s0, p0);
    add4<kF32>(a, s1, p1);
  }
  if (v < nvec) add4<kF32>(a, __ldg(s4 + v), __ldg(p4 + v));

  const long long tail0 = head + 4 * nvec;
  const long long rest = head + (n - tail0);
  for (long long j = tid; j < rest; j += stride) {
    const long long i = j < head ? j : tail0 + (j - head);
    add(a, __ldg(status + i), prog<kF32>(__ldg(progress + i)));
  }

  // block reduction: warp shuffles, then the warps in order
  __shared__ float partial[kWarps][kFields];
  __shared__ int is_last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int s = 0; s < kS; ++s) {
    int c = a.cnt[s];
    float su = a.sum[s], h = a.hi[s], l = a.lo[s];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      c += __shfl_xor_sync(0xffffffffu, c, off);
      su += __shfl_xor_sync(0xffffffffu, su, off);
      h = fmaxf(h, __shfl_xor_sync(0xffffffffu, h, off));
      l = fminf(l, __shfl_xor_sync(0xffffffffu, l, off));
    }
    if (lane == 0) {
      partial[warp][s] = __int_as_float(c);
      partial[warp][kS + s] = su;
      partial[warp][2 * kS + s] = h;
      partial[warp][3 * kS + s] = l;
    }
  }
  __syncthreads();
  // partials are field-major: field f of block b at partials[f * grid + b]
  unsigned int* partials = scratch + 1;
  if (threadIdx.x < kFields) {
    const int f = threadIdx.x;
    float x = partial[0][f];
    for (int w = 1; w < kWarps; ++w) x = combine(f / kS, x, partial[w][f]);
    partials[static_cast<long long>(f) * gridDim.x + blockIdx.x] = __float_as_uint(x);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(scratch, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!is_last) return;

  // The last block: every partial is visible. Warp w combines fields w,
  // w + kWarps, ...: lane l takes blocks l, l + 32, ... in order, then a
  // fixed shuffle tree joins the lanes (sums in f64), so the order of the
  // whole reduction is fixed by the grid alone.
  __threadfence();
  __shared__ float total[kFields];
  __shared__ double sums[kS];
  for (int f = warp; f < kFields; f += kWarps) {
    const int kind = f / kS;
    const unsigned int* col = partials + static_cast<long long>(f) * gridDim.x;
    if (kind == 1) {
      double acc = 0.0;
#pragma unroll 4
      for (unsigned int b = lane; b < gridDim.x; b += 32) {
        acc += static_cast<double>(__uint_as_float(__ldcg(col + b)));
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) sums[f - kS] = acc;
    } else {
      float acc = kind == 0 ? 0.f : (kind == 2 ? -kBig : kBig);  // 0.f: int 0's bits
#pragma unroll 4
      for (unsigned int b = lane; b < gridDim.x; b += 32) {
        acc = combine(kind, acc, __uint_as_float(__ldcg(col + b)));
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        acc = combine(kind, acc, __shfl_xor_sync(0xffffffffu, acc, off));
      }
      if (lane == 0) total[f] = acc;
    }
  }
  __syncthreads();
  if (threadIdx.x < kS) {
    const int s = threadIdx.x;
    const int c = __float_as_int(total[s]);
    const bool present = c > 0;
    const float sum = static_cast<float>(sums[s]);
    const float count = static_cast<float>(c);
    out[s] = static_cast<unsigned int>(c);
    out[kS + s] = __float_as_uint(present ? sum / count : 0.f);
    out[2 * kS + s] = __float_as_uint(present ? total[2 * kS + s] : 0.f);
    out[3 * kS + s] = __float_as_uint(present ? total[3 * kS + s] : 0.f);
  }
}

}  // namespace

extern "C" {

// status: n int32; progress: n int32 (progress_f32 = 0) or f32 (1); both
// 4-byte aligned. num_statuses must be the S built in. scratch: 1 + grid x
// 4 x S words. out: 4 x S words. Returns cudaGetLastError()
// (cudaErrorInvalidValue on what the kernel does not take).
int aggregate_launch(const void* status, const void* progress, long long n,
                     int progress_f32, int num_statuses, int grid, void* scratch,
                     void* out, void* stream) {
  const uintptr_t sa = reinterpret_cast<uintptr_t>(status);
  const uintptr_t pa = reinterpret_cast<uintptr_t>(progress);
  if (n < 1 || num_statuses != kS || grid < 1 || (sa & 3) || (pa & 3) ||
      scratch == nullptr || out == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // 16-byte loads where both pointers reach a 16-byte boundary together
  long long head = n, nvec = 0;
  if (((sa ^ pa) & 15) == 0) {
    const long long to_boundary = static_cast<long long>(((16 - (sa & 15)) & 15) / 4);
    head = to_boundary < n ? to_boundary : n;
    nvec = (n - head) / 4;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(scratch, 0, sizeof(unsigned int), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int* s = static_cast<const int*>(status);
  const int* p = static_cast<const int*>(progress);
  unsigned int* sc = static_cast<unsigned int*>(scratch);
  unsigned int* o = static_cast<unsigned int*>(out);
  if (progress_f32) {
    aggregate_kernel<true><<<grid, kThreads, 0, st>>>(s, p, n, head, nvec, sc, o);
  } else {
    aggregate_kernel<false><<<grid, kThreads, 0, st>>>(s, p, n, head, nvec, sc, o);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
