// Two-level binary search over sorted int64 keys, shared by multisearch.cu
// and fused_ingest.cu.
//
// The top of the search runs in a shared-memory sample of the keys: every
// step-th key, step = ceil(n / cap), at most cap of them. A search of the
// sample narrows a bound to a window of step - 1 keys; for n <= cap the
// sample is the whole array and the answer. The window is then searched in
// global memory, where the keys stay resident in the 50 MB L2.
//
// A search computes two bounds at once, lo1 = #{a < x1} and lo2 = #{a < x2}
// (or #{a <= x2}): one descent, whose two ranges share each probe while
// they agree. For x1 == x2 that holds until a probe equals the query, so
// (count_lt, count_le) of one query cost one search where the keys differ.
// Each thread carries Q searches interleaved, so that several independent
// chains of dependent loads are in flight at once.
#pragma once

#include <cuda_runtime.h>

#include <atomic>

namespace search {

// Binary-searches the ranges [lo1, hi1) and [lo2, hi2) of the sorted array a
// for Q searches at once; on return lo1 counts the keys < x1 and lo2 those
// < x2 (LE2: <= x2) below each range's start plus inside it. An empty range
// (lo == hi) loads nothing.
template <int Q, bool LE2>
__device__ __forceinline__ void bound_pair(const long long* a, const long long (&x1)[Q],
                                           const long long (&x2)[Q], int (&lo1)[Q],
                                           int (&hi1)[Q], int (&lo2)[Q], int (&hi2)[Q]) {
  bool busy = true;
  while (busy) {
    busy = false;
#pragma unroll
    for (int j = 0; j < Q; ++j) {
      const bool s1 = lo1[j] < hi1[j], s2 = lo2[j] < hi2[j];
      const int m1 = lo1[j] + ((hi1[j] - lo1[j]) >> 1);
      const int m2 = lo2[j] + ((hi2[j] - lo2[j]) >> 1);
      const bool shared = s1 && lo1[j] == lo2[j] && hi1[j] == hi2[j];
      const long long k1 = s1 ? a[m1] : 0;
      const long long k2 = shared ? k1 : (s2 ? a[m2] : 0);
      if (s1) {
        if (k1 < x1[j]) lo1[j] = m1 + 1; else hi1[j] = m1;
      }
      if (s2) {
        if (LE2 ? k2 <= x2[j] : k2 < x2[j]) lo2[j] = m2 + 1; else hi2[j] = m2;
      }
      busy |= lo1[j] < hi1[j] || lo2[j] < hi2[j];
    }
  }
}

// A sample of n sorted keys: keys[0], keys[step], .., m of them.
struct Sample {
  const long long* keys;  // in shared memory
  long long step, m;
};

// Every thread of the block copies its share of the sample of keys[0, n)
// (n >= 1) into smem, which holds cap keys; the caller synchronises.
template <int THREADS>
__device__ __forceinline__ Sample load_sample(long long* smem, int cap,
                                              const long long* __restrict__ keys, long long n) {
  const long long step = (n + cap - 1) / cap;
  const long long m = (n + step - 1) / step;
#pragma unroll 8
  for (long long j = threadIdx.x; j < m; j += THREADS) smem[j] = keys[j * step];
  return {smem, step, m};
}

// Both bounds of Q searches over keys[0, n): first in the sample, then in
// the window it leaves. Inactive searches load nothing and return 0.
template <int Q, bool LE2>
__device__ __forceinline__ void two_level(const Sample& smp, const long long* keys, long long n,
                                          const long long (&x1)[Q], const long long (&x2)[Q],
                                          const bool (&active)[Q], int (&b1)[Q], int (&b2)[Q]) {
  int hi1[Q], hi2[Q];
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    b1[j] = b2[j] = 0;
    hi1[j] = hi2[j] = active[j] ? (int)smp.m : 0;
  }
  bound_pair<Q, LE2>(smp.keys, x1, x2, b1, hi1, b2, hi2);
  // c samples below the bound: the answer lies in ((c-1)*step, c*step]
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    const long long c1 = b1[j], c2 = b2[j];
    b1[j] = (int)(c1 > 0 ? (c1 - 1) * smp.step + 1 : 0);
    hi1[j] = (int)(c1 * smp.step < n ? c1 * smp.step : n);
    b2[j] = (int)(c2 > 0 ? (c2 - 1) * smp.step + 1 : 0);
    hi2[j] = (int)(c2 * smp.step < n ? c2 * smp.step : n);
  }
  bound_pair<Q, LE2>(keys, x1, x2, b1, hi1, b2, hi2);
}

constexpr int MAX_DEVICES = 64;

// The CTAs of kernel resident on the current device at once, the size of a
// persistent grid. The first call on a device opts the kernel in to smem
// bytes of dynamic shared memory (above 48 KiB only after this; a refused
// launch never runs) and asks the occupancy; later calls read cache.
template <typename Kernel>
cudaError_t resident_ctas(Kernel kernel, int threads, size_t smem,
                          std::atomic<long long> (&cache)[MAX_DEVICES], long long* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && (*out = cache[dev].load(std::memory_order_acquire)) > 0)
    return cudaSuccess;
  if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
    return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) !=
      cudaSuccess)
    return err;
  *out = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (dev < MAX_DEVICES) cache[dev].store(*out, std::memory_order_release);
  return cudaSuccess;
}

}  // namespace search
