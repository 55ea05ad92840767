// bitonic_sort_tiles: sort each power-of-two tile of (int64 key, int32 payload).
//
// Replaces the Pallas kernel repro/kernels/bitonic.py::_bitonic_kernel
// (wrapper bitonic_sort_tiles). On the TPU a whole tile sits in VMEM and the
// compare-exchange network runs there. The ingest path's tiles hold 2^21
// entries (12 B each, 24 MiB), far beyond one Hopper CTA's 227 KB of shared
// memory, so the same network is split by distance:
//   * every substage whose partner distance j is below CHUNK = 4096 runs in
//     shared memory: one CTA loads a 4096-entry chunk (48 KiB) and runs all
//     consecutive short substages there before writing it back
//     (bitonic_smem: the full sort of each chunk first, then the tail of each
//     later merge);
//   * every substage with j >= CHUNK is one global-memory pass, one thread
//     per compare-exchange pair (bitonic_global).
// For a tile of 2^21 that is 1 + 9 shared-memory passes and 45 global passes.
//
// The network is the reference's: stage k (bitonic block size) sorts
// ascending where bit k of the in-tile index is 0, and descending elsewhere;
// the last stage (k = tile) is ascending everywhere. Like the reference it is
// not stable: keys come out bit-equal to a stable sort, payloads equal as a
// multiset per tile (the contract in repro/kernels/ref.py).
//
// A bitonic network was chosen over a radix sort on the 64-bit key because it
// keeps the reference's network and contract unchanged, so rank_all_chunk's
// stability patch carries over as it is.
//
// Bound on the H100: memory. The least traffic is each entry read and written
// once (24 B an entry); this network streams the array through device memory
// once per pass, about 55 passes at tile 2^21. Fewer passes (a larger
// shared-memory chunk, a cluster-wide merge, or a radix sort) are the way to
// a faster kernel.

#include <cuda_runtime.h>

namespace {

constexpr int CHUNK = 4096;
constexpr int THREADS = 1024;
constexpr long long KEY_PAD = 0x7FFFFFFFFFFFFFFFLL;

__device__ __forceinline__ long long pair_lo(long long p, long long j) {
  // index of the lower element of compare-exchange pair p at distance j
  return ((p & ~(j - 1)) << 1) | (p & (j - 1));
}

__global__ void bitonic_smem(long long* __restrict__ keys,
                             int* __restrict__ vals, long long n,
                             long long tile, long long k_first,
                             long long k_last, long long j_first) {
  __shared__ long long sk[CHUNK];
  __shared__ int sv[CHUNK];
  const long long base = (long long)blockIdx.x * CHUNK;
  for (int i = threadIdx.x; i < CHUNK; i += THREADS) {
    long long g = base + i;
    sk[i] = g < n ? keys[g] : KEY_PAD;
    sv[i] = g < n ? vals[g] : 0;
  }
  __syncthreads();
  for (long long k = k_first; k <= k_last; k <<= 1) {
    for (long long j = (k == k_first ? j_first : k >> 1); j >= 1; j >>= 1) {
      for (int p = threadIdx.x; p < CHUNK / 2; p += THREADS) {
        const int a = (int)pair_lo(p, j);
        const int b = a + (int)j;
        const bool asc = (((base + a) & (tile - 1)) & k) == 0;
        const long long ka = sk[a], kb = sk[b];
        if (asc ? (ka > kb) : (ka < kb)) {
          sk[a] = kb;
          sk[b] = ka;
          const int t = sv[a];
          sv[a] = sv[b];
          sv[b] = t;
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < CHUNK; i += THREADS) {
    long long g = base + i;
    if (g < n) {
      keys[g] = sk[i];
      vals[g] = sv[i];
    }
  }
}

__global__ void bitonic_global(long long* __restrict__ keys,
                               int* __restrict__ vals, long long n,
                               long long tile, long long k, long long j) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n / 2) return;
  const long long a = pair_lo(p, j);
  const long long b = a + j;
  const bool asc = ((a & (tile - 1)) & k) == 0;
  const long long ka = keys[a], kb = keys[b];
  if (asc ? (ka > kb) : (ka < kb)) {
    keys[a] = kb;
    keys[b] = ka;
    const int t = vals[a];
    vals[a] = vals[b];
    vals[b] = t;
  }
}

}  // namespace

// Sorts keys/vals in place; n is a positive multiple of tile, tile a power of
// two.
extern "C" int bitonic_sort_tiles(void* keys, void* vals, long long n,
                                  long long tile, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  long long* k64 = (long long*)keys;
  int* v32 = (int*)vals;
  const unsigned chunks = (unsigned)((n + CHUNK - 1) / CHUNK);
  const long long local_last = tile < CHUNK ? tile : CHUNK;
  bitonic_smem<<<chunks, THREADS, 0, s>>>(k64, v32, n, tile, 2, local_last, 1);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const unsigned pair_blocks = (unsigned)((n / 2 + 255) / 256);
  for (long long k = 2LL * CHUNK; k <= tile; k <<= 1) {
    for (long long j = k >> 1; j >= CHUNK; j >>= 1) {
      bitonic_global<<<pair_blocks, 256, 0, s>>>(k64, v32, n, tile, k, j);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    bitonic_smem<<<chunks, THREADS, 0, s>>>(k64, v32, n, tile, k, k,
                                           CHUNK / 2);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
