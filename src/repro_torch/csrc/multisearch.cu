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
// lt and le come from one descent (search.cuh): the lower and the upper
// bound step together and share each probe while their ranges agree, which
// holds until a probe equals the query; from there each finishes its own
// range, their loads in flight side by side. Each thread carries QUERIES = 2 queries
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

#include "search.cuh"

namespace {

constexpr int SAMPLE = 8192;
constexpr int THREADS = 256;
constexpr int QUERIES = 2;
constexpr size_t SMEM = SAMPLE * sizeof(long long);

__global__ void __launch_bounds__(THREADS)
multisearch_counts_kernel(const long long* __restrict__ keys, long long n,
                          const long long* __restrict__ queries, long long q,
                          int* __restrict__ lt, int* __restrict__ le) {
  extern __shared__ __align__(16) long long sample[];
  const search::Sample smp = search::load_sample<THREADS>(sample, SAMPLE, keys, n);
  __syncthreads();
  const long long per_cta = (long long)THREADS * QUERIES;
  bool all[QUERIES];
#pragma unroll
  for (int j = 0; j < QUERIES; ++j) all[j] = true;
  for (long long base = (long long)blockIdx.x * per_cta; base < q;
       base += (long long)gridDim.x * per_cta) {
    long long x[QUERIES];
#pragma unroll
    for (int j = 0; j < QUERIES; ++j) {
      const long long i = base + threadIdx.x + (long long)j * THREADS;
      x[j] = i < q ? queries[i] : 0;
    }
    int c_lt[QUERIES], c_le[QUERIES];
    search::two_level<QUERIES, true>(smp, keys, n, x, x, all, c_lt, c_le);
#pragma unroll
    for (int j = 0; j < QUERIES; ++j) {
      const long long i = base + threadIdx.x + (long long)j * THREADS;
      if (i < q) {
        lt[i] = c_lt[j];
        le[i] = c_le[j];
      }
    }
  }
}

std::atomic<long long> resident[search::MAX_DEVICES];

}  // namespace

// *launches is the number of kernels queued: 1, or 0 on an error.
extern "C" int multisearch_counts(const void* keys, long long n,
                                  const void* queries, long long q, void* lt,
                                  void* le, void* stream, int* launches) {
  *launches = 0;
  long long ctas = 0;
  cudaError_t err =
      search::resident_ctas(multisearch_counts_kernel, THREADS, SMEM, resident, &ctas);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (q + (long long)THREADS * QUERIES - 1) / ((long long)THREADS * QUERIES);
  const unsigned blocks = (unsigned)(tiles < ctas ? tiles : ctas);
  multisearch_counts_kernel<<<blocks, THREADS, SMEM, (cudaStream_t)stream>>>(
      (const long long*)keys, n, (const long long*)queries, q, (int*)lt, (int*)le);
  err = cudaGetLastError();
  *launches = err == cudaSuccess;
  return (int)err;
}
