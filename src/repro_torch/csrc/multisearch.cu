// multisearch_counts: (count_lt, count_le) of int64 queries in sorted int64 keys.
//
// Replaces the Pallas kernel repro/kernels/multisearch.py::_count_kernel
// (wrapper multisearch_counts). The TPU kernel counts by a dense
// compare-reduce of every query tile against every key chunk, O(q * n) work,
// because a TPU has no fast gather. Hopper gathers from L2 cheaply, so this
// kernel binary-searches the keys, O(q log n) loads, in two levels:
//
//   * the top of the search tree in shared memory: every CTA first loads a
//     sample of the keys, every step-th one with step = ceil(n / SAMPLE)
//     and SAMPLE = 8192 (64 KiB, dynamic shared memory opted in with
//     cudaFuncSetAttribute). A query's search of the sample narrows each
//     bound to a window of step - 1 keys; for n <= SAMPLE the sample is the
//     whole array and the answer;
//   * the window in global memory, where the keys (at most 16 MiB on the
//     ingest path) stay resident in the 50 MB L2.
//
// lt and le come from one descent: the lower and the upper bound step
// together and share each probe while their ranges agree, which holds until
// a probe equals the query; from there each finishes its own range, their
// loads in flight side by side. Each thread carries QUERIES = 2 queries
// through the descent interleaved, so that several independent chains of
// dependent loads are in flight per thread (4 queries a thread, with more
// registers and fewer threads resident, was slower); query loads and count stores
// stay coalesced (query j of a thread is j * THREADS apart). The grid is
// persistent (as many CTAs as fit on the card at once, each walking the
// query tiles), so the sample is loaded once per resident CTA, not once per
// query tile.
//
// Bound on the H100: the least bytes that must move are the keys once, the
// queries once and the two int32 counts once (0.045 ms at the ingest path's
// Q1 shape). That bound is out of reach for a search: each query waits on a
// chain of dependent loads, at n = 2^21 about 13 shared-memory probes and
// then 8 L2 probes (log2(256)) per bound, where one plain binary search
// takes 21 L2 probes per bound. The L2 latency of those chains is what the
// kernel waits on.
//
// n == 0 and q == 0 are answered by the wrapper without a launch.

#include <cuda_runtime.h>

#include <atomic>

namespace {

constexpr int SAMPLE = 8192;
constexpr int THREADS = 256;
constexpr int QUERIES = 2;
constexpr size_t SMEM = SAMPLE * sizeof(long long);

// Counts of keys < x (lo1) and <= x (lo2) in the ranges [lo1, hi1) and
// [lo2, hi2) of the sorted array a, for QUERIES queries at once; the bounds
// hold the answers on return. A probe is shared while the two ranges agree.
__device__ __forceinline__ void equal_range(const long long* a,
                                            const long long (&x)[QUERIES],
                                            int (&lo1)[QUERIES], int (&hi1)[QUERIES],
                                            int (&lo2)[QUERIES], int (&hi2)[QUERIES]) {
  bool busy = true;
  while (busy) {
    busy = false;
#pragma unroll
    for (int j = 0; j < QUERIES; ++j) {
      const bool s1 = lo1[j] < hi1[j], s2 = lo2[j] < hi2[j];
      const int m1 = lo1[j] + ((hi1[j] - lo1[j]) >> 1);
      const int m2 = lo2[j] + ((hi2[j] - lo2[j]) >> 1);
      const bool shared = s1 && lo1[j] == lo2[j] && hi1[j] == hi2[j];
      const long long k1 = s1 ? a[m1] : 0;
      const long long k2 = shared ? k1 : (s2 ? a[m2] : 0);
      if (s1) {
        if (k1 < x[j]) lo1[j] = m1 + 1; else hi1[j] = m1;
      }
      if (s2) {
        if (k2 <= x[j]) lo2[j] = m2 + 1; else hi2[j] = m2;
      }
      busy |= lo1[j] < hi1[j] || lo2[j] < hi2[j];
    }
  }
}

__global__ void __launch_bounds__(THREADS)
multisearch_counts_kernel(const long long* __restrict__ keys, long long n,
                          const long long* __restrict__ queries, long long q,
                          int* __restrict__ lt, int* __restrict__ le) {
  extern __shared__ __align__(16) long long sample[];
  const long long step = (n + SAMPLE - 1) / SAMPLE;
  const long long m = (n + step - 1) / step;  // samples: keys[0], keys[step], ..
#pragma unroll 8
  for (long long j = threadIdx.x; j < m; j += THREADS) sample[j] = keys[j * step];
  __syncthreads();
  const long long per_cta = (long long)THREADS * QUERIES;
  for (long long base = (long long)blockIdx.x * per_cta; base < q;
       base += (long long)gridDim.x * per_cta) {
    long long x[QUERIES];
    int lo1[QUERIES], hi1[QUERIES], lo2[QUERIES], hi2[QUERIES];
#pragma unroll
    for (int j = 0; j < QUERIES; ++j) {
      const long long i = base + threadIdx.x + (long long)j * THREADS;
      x[j] = i < q ? queries[i] : 0;
      lo1[j] = lo2[j] = 0;
      hi1[j] = hi2[j] = (int)m;
    }
    equal_range(sample, x, lo1, hi1, lo2, hi2);
    // c samples below the bound: the answer lies in ((c-1)*step, c*step]
#pragma unroll
    for (int j = 0; j < QUERIES; ++j) {
      const long long c1 = lo1[j], c2 = lo2[j];
      lo1[j] = (int)(c1 > 0 ? (c1 - 1) * step + 1 : 0);
      hi1[j] = (int)(c1 * step < n ? c1 * step : n);
      lo2[j] = (int)(c2 > 0 ? (c2 - 1) * step + 1 : 0);
      hi2[j] = (int)(c2 * step < n ? c2 * step : n);
    }
    equal_range(keys, x, lo1, hi1, lo2, hi2);
#pragma unroll
    for (int j = 0; j < QUERIES; ++j) {
      const long long i = base + threadIdx.x + (long long)j * THREADS;
      if (i < q) {
        lt[i] = lo1[j];
        le[i] = lo2[j];
      }
    }
  }
}

constexpr int MAX_DEVICES = 64;

// The CTAs resident on the current device at once, the persistent grid's
// size. The first call on a device opts the kernel in to SMEM bytes of
// dynamic shared memory (above 48 KiB only after this; a refused launch
// never runs) and asks the occupancy; later calls read the cached count.
cudaError_t resident_ctas(long long* out) {
  static std::atomic<long long> cached[MAX_DEVICES];
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && (*out = cached[dev].load(std::memory_order_acquire)) > 0)
    return cudaSuccess;
  if ((err = cudaFuncSetAttribute(multisearch_counts_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM)) !=
      cudaSuccess)
    return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, multisearch_counts_kernel,
                                                           THREADS, SMEM)) != cudaSuccess)
    return err;
  *out = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (dev < MAX_DEVICES) cached[dev].store(*out, std::memory_order_release);
  return cudaSuccess;
}

}  // namespace

// *launches is the number of kernels queued: 1, or 0 on an error.
extern "C" int multisearch_counts(const void* keys, long long n,
                                  const void* queries, long long q, void* lt,
                                  void* le, void* stream, int* launches) {
  *launches = 0;
  long long resident = 0;
  cudaError_t err = resident_ctas(&resident);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (q + (long long)THREADS * QUERIES - 1) / ((long long)THREADS * QUERIES);
  const unsigned blocks = (unsigned)(tiles < resident ? tiles : resident);
  multisearch_counts_kernel<<<blocks, THREADS, SMEM, (cudaStream_t)stream>>>(
      (const long long*)keys, n, (const long long*)queries, q, (int*)lt, (int*)le);
  err = cudaGetLastError();
  *launches = err == cudaSuccess;
  return (int)err;
}
