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
// Rows: the keys and queries may be B rows of one bank (a tenant each), row
// b's n keys at keys + b * key_stride and its q queries at queries + b *
// query_stride; the counts are written densely, (B, q). The persistent grid
// walks the (row, query tile) pairs row-major: each CTA loads its sample
// from the row of the tile it works on (again only when that row changes),
// and since every CTA advances at about the same pace, the grid searches
// about one row at a time, so one row's keys, not all B rows', compete for
// the L2. (A grid with a row axis searched all four rows of the bank at
// once and took 1.37x four one-row calls at Q1's full shape on an NVIDIA
// H100 80GB HBM3 at 700 W, chip_smoke.py.) B = 1 is the one-row search,
// tile for tile.
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
multisearch_counts_kernel(const long long* __restrict__ keys, long long rows, long long n,
                          long long key_stride, const long long* __restrict__ queries,
                          long long q, long long query_stride, int* __restrict__ lt,
                          int* __restrict__ le) {
  extern __shared__ __align__(16) long long sample[];
  const long long per_cta = (long long)THREADS * QUERIES;
  const long long tiles = (q + per_cta - 1) / per_cta;  // a row's query tiles
  bool all[QUERIES];
#pragma unroll
  for (int j = 0; j < QUERIES; ++j) all[j] = true;
  long long row = -1;  // the row whose sample is loaded
  search::Sample smp{};
  const long long* rkeys = keys;
  for (long long w = blockIdx.x; w < rows * tiles; w += gridDim.x) {
    const long long b = w / tiles;
    if (b != row) {  // uniform across the CTA
      row = b;
      rkeys = keys + row * key_stride;
      __syncthreads();  // every thread is done with the old sample
      smp = search::load_sample<THREADS>(sample, SAMPLE, rkeys, n);
      __syncthreads();
    }
    const long long base = (w - row * tiles) * per_cta;
    const long long* rq = queries + row * query_stride;
    long long x[QUERIES];
#pragma unroll
    for (int j = 0; j < QUERIES; ++j) {
      const long long i = base + threadIdx.x + (long long)j * THREADS;
      x[j] = i < q ? rq[i] : 0;
    }
    int c_lt[QUERIES], c_le[QUERIES];
    search::two_level<QUERIES, true>(smp, rkeys, n, x, x, all, c_lt, c_le);
#pragma unroll
    for (int j = 0; j < QUERIES; ++j) {
      const long long i = base + threadIdx.x + (long long)j * THREADS;
      if (i < q) {
        lt[row * q + i] = c_lt[j];
        le[row * q + i] = c_le[j];
      }
    }
  }
}

std::atomic<long long> resident[search::MAX_DEVICES];

}  // namespace

// *launches is the number of kernels queued: 1, or 0 on an error.
extern "C" int multisearch_counts(const void* keys, long long rows, long long n,
                                  long long key_stride, const void* queries, long long q,
                                  long long query_stride, void* lt, void* le, void* stream,
                                  int* launches) {
  *launches = 0;
  long long ctas = 0;
  cudaError_t err =
      search::resident_ctas(multisearch_counts_kernel, THREADS, SMEM, resident, &ctas);
  if (err != cudaSuccess) return (int)err;
  const long long tiles =
      rows * ((q + (long long)THREADS * QUERIES - 1) / ((long long)THREADS * QUERIES));
  const unsigned blocks = (unsigned)(tiles < ctas ? tiles : ctas);
  multisearch_counts_kernel<<<blocks, THREADS, SMEM, (cudaStream_t)stream>>>(
      (const long long*)keys, rows, n, key_stride, (const long long*)queries, q, query_stride,
      (int*)lt, (int*)le);
  err = cudaGetLastError();
  *launches = err == cudaSuccess;
  return (int)err;
}
