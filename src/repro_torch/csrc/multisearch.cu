// multisearch_counts: (count_lt, count_le) of int64 queries in sorted int64 keys.
//
// Replaces the Pallas kernel repro/kernels/multisearch.py::_count_kernel
// (wrapper multisearch_counts). The TPU kernel counts by a dense
// compare-reduce of every query tile against every key chunk, O(q * n) work,
// because a TPU has no fast gather. Hopper gathers from L2 cheaply, so this
// kernel gives each query one thread and binary-searches the keys: O(q log n)
// loads, the upper bound searching only [lt, n).
//
// Bound on the H100: each query reads about log2(n) keys scattered over the
// structure and writes two int32 counts; the keys (at most 16 MiB on the
// ingest path) stay in the 50 MB L2 after the first queries touch them, so
// the least bytes that must move are the keys once, the queries once and the
// counts once. The dependent chain of about log2(n) L2 loads per thread is
// what it waits on; many threads in flight per SM hide part of that latency.
//
// n == 0 and q == 0 are answered by the wrapper without a launch.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int lower_bound(const long long* __restrict__ a,
                                           int lo, int hi, long long x) {
  while (lo < hi) {
    int mid = lo + ((hi - lo) >> 1);
    if (a[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ int upper_bound(const long long* __restrict__ a,
                                           int lo, int hi, long long x) {
  while (lo < hi) {
    int mid = lo + ((hi - lo) >> 1);
    if (a[mid] <= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void multisearch_counts_kernel(const long long* __restrict__ keys,
                                          int n,
                                          const long long* __restrict__ queries,
                                          long long q, int* __restrict__ lt,
                                          int* __restrict__ le) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= q) return;
  long long x = queries[i];
  int l = lower_bound(keys, 0, n, x);
  lt[i] = l;
  le[i] = upper_bound(keys, l, n, x);
}

}  // namespace

extern "C" int multisearch_counts(const void* keys, long long n,
                                  const void* queries, long long q, void* lt,
                                  void* le, void* stream) {
  const int threads = 256;
  long long blocks = (q + threads - 1) / threads;
  multisearch_counts_kernel<<<(unsigned)blocks, threads, 0,
                              (cudaStream_t)stream>>>(
      (const long long*)keys, (int)n, (const long long*)queries, q, (int*)lt,
      (int*)le);
  return (int)cudaGetLastError();
}
