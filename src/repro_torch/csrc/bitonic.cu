// bitonic_sort_tiles: sort each power-of-two tile of (int64 key, int32 payload).
//
// Replaces the Pallas kernel repro/kernels/bitonic.py::_bitonic_kernel
// (wrapper bitonic_sort_tiles). On the TPU a whole tile sits in VMEM and a
// bitonic compare-exchange network runs there. The ingest path's tiles hold
// 2^21 entries (12 B each, 24 MiB), far beyond one Hopper CTA's 227 KB of
// shared memory. Split by partner distance, the same network needs one
// global pass for every substage whose distance exceeds what a CTA holds:
// 55 passes over the whole array at tile 2^21. So this kernel is a merge
// sort instead, which touches device memory once per doubling of the run:
//
//   * block sort (one launch): a CTA of THREADS = 256 threads sorts
//     BLOCK = 4096 entries in 51 KiB of dynamic shared memory (opted in with
//     cudaFuncSetAttribute). Each thread sorts ITEMS = 16 entries in
//     registers by odd-even transposition, then the CTA merges runs of
//     16, 32, .. in shared memory, every thread producing 16 outputs of a
//     merge by its own merge-path split. Tiles of at most BLOCK entries are
//     finished here, many tiles to a CTA;
//   * merge passes (log2(tile / BLOCK) launches): each pass merges pairs
//     of sorted runs, ping-ponging between the output and one scratch
//     buffer, so that the last pass lands in the output. A CTA owns BLOCK
//     consecutive outputs: it finds where its first and last output split
//     the two input runs by a cooperative 128-ary merge-path search in
//     global memory (three rounds at runs of 2^20), stages the two input
//     windows in shared memory with coalesced loads, merges there as the
//     block sort does, and writes its outputs back coalesced.
//
// Launches per call: 1 for tile <= 4096; 9 at tile 2^20; 10 at tile 2^21.
// Three CTAs share an SM (80 registers a thread), so one CTA's global loads
// and stores overlap another's merging. A block of 8192 entries with one
// CTA of 512 threads an SM makes one pass fewer but was slower on the H100.
//
// Every merge takes the left run's entry on equal keys, and the register
// sort only swaps strictly greater keys, so the sort is stable: keys come
// out bit-equal to a stable sort and payloads equal to it entry for entry,
// which meets the reference's contract (payloads equal as a multiset per
// tile) a fortiori.
//
// Bound on the H100: memory. The least traffic is each entry read and written
// once (24 B an entry); this kernel reads and writes the array once in the
// block sort and once per merge pass, 1 + log2(tile / 4096) times in all.
// Shared-memory slots are padded by one every 16 (slot(i) = i + i / 16), so
// that the 16 consecutive entries a thread owns land on distinct banks.

#include <cuda_runtime.h>

#include <atomic>

namespace {

constexpr int ITEMS = 16;
constexpr int THREADS = 256;
constexpr int BLOCK = ITEMS * THREADS;  // 4096 entries
constexpr int SLOTS = BLOCK + BLOCK / 16;
constexpr size_t SMEM = SLOTS * (sizeof(long long) + sizeof(int));
constexpr int HALF = THREADS / 2;  // threads per split search
constexpr long long KEY_PAD = 0x7FFFFFFFFFFFFFFFLL;

__device__ __forceinline__ int slot(int i) { return i + (i >> 4); }

// The ITEMS registers of this thread, to slots t*ITEMS .. t*ITEMS+ITEMS-1.
__device__ __forceinline__ void regs_to_smem(long long* sk, int* sv,
                                             const long long (&k)[ITEMS],
                                             const int (&v)[ITEMS]) {
  const int base = threadIdx.x * ITEMS;
#pragma unroll
  for (int x = 0; x < ITEMS; ++x) {
    sk[slot(base + x)] = k[x];
    sv[slot(base + x)] = v[x];
  }
}

// Merge path inside shared memory: the ITEMS outputs from diagonal d on of
// the stable merge of runs A = [a0, a0 + la) and B = [b0, b0 + lb), into
// registers. On equal keys A's entry comes first.
__device__ __forceinline__ void merge_items(const long long* sk, const int* sv,
                                            int a0, int la, int b0, int lb,
                                            int d, long long (&k)[ITEMS],
                                            int (&v)[ITEMS]) {
  int lo = max(0, d - lb), hi = min(d, la);
  while (lo < hi) {  // the number of A's entries among the first d outputs
    const int mid = (lo + hi) >> 1;
    if (sk[slot(a0 + mid)] <= sk[slot(b0 + d - mid - 1)]) lo = mid + 1;
    else hi = mid;
  }
  int ia = lo, ib = d - lo;
  long long ka = ia < la ? sk[slot(a0 + ia)] : 0;
  long long kb = ib < lb ? sk[slot(b0 + ib)] : 0;
#pragma unroll
  for (int x = 0; x < ITEMS; ++x) {
    const bool take_a = ib >= lb || (ia < la && ka <= kb);
    const int src = take_a ? a0 + ia : b0 + ib;
    k[x] = take_a ? ka : kb;
    v[x] = sv[slot(src)];
    ia += take_a;
    ib += !take_a;
    const bool more = take_a ? ia < la : ib < lb;
    const long long next = more ? sk[slot(src + 1)] : 0;
    if (take_a) ka = next; else kb = next;
  }
}

__global__ void __launch_bounds__(THREADS, 3)
block_sort(const long long* __restrict__ keys, const int* __restrict__ vals,
           long long* __restrict__ out_k, int* __restrict__ out_v, long long n,
           int span) {  // span = min(tile, BLOCK): the sorted run length made here
  extern __shared__ __align__(16) unsigned char smem[];
  long long* sk = reinterpret_cast<long long*>(smem);
  int* sv = reinterpret_cast<int*>(sk + SLOTS);
  const long long base = (long long)blockIdx.x * BLOCK;
  const int t = threadIdx.x;
#pragma unroll
  for (int x = 0; x < ITEMS; ++x) {
    const int e = t + x * THREADS;
    const long long g = base + e;
    sk[slot(e)] = g < n ? keys[g] : KEY_PAD;
    sv[slot(e)] = g < n ? vals[g] : 0;
  }
  __syncthreads();
  long long k[ITEMS];
  int v[ITEMS];
#pragma unroll
  for (int x = 0; x < ITEMS; ++x) {
    k[x] = sk[slot(t * ITEMS + x)];
    v[x] = sv[slot(t * ITEMS + x)];
  }
  // odd-even transposition sort of the thread's entries, within tiles when
  // a tile is shorter than ITEMS (each thread's entries start a tile then)
#pragma unroll
  for (int round = 0; round < ITEMS; ++round) {
#pragma unroll
    for (int x = round & 1; x + 1 < ITEMS; x += 2) {
      if (((x + 1) & (span - 1)) != 0 && k[x] > k[x + 1]) {
        const long long tk = k[x];
        k[x] = k[x + 1];
        k[x + 1] = tk;
        const int tv = v[x];
        v[x] = v[x + 1];
        v[x + 1] = tv;
      }
    }
  }
  for (int w = ITEMS;; w <<= 1) {
    __syncthreads();  // every thread has read the previous level
    regs_to_smem(sk, sv, k, v);
    __syncthreads();
    if (2 * w > span) break;
    const int o = t * ITEMS;
    const int pair = o & ~(2 * w - 1);
    merge_items(sk, sv, pair, w, pair + w, w, o - pair, k, v);
  }
#pragma unroll
  for (int x = 0; x < ITEMS; ++x) {
    const int e = t + x * THREADS;
    const long long g = base + e;
    if (g < n) {
      out_k[g] = sk[slot(e)];
      out_v[g] = sv[slot(e)];
    }
  }
}

// One merge pass: pairs of sorted runs of length w (a tile holds an even
// number of them) into runs of 2w. CTA b owns outputs [b*BLOCK, b*BLOCK + BLOCK).
__global__ void __launch_bounds__(THREADS, 3)
merge_pass(const long long* __restrict__ in_k, const int* __restrict__ in_v,
           long long* __restrict__ out_k, int* __restrict__ out_v,
           long long w) {
  extern __shared__ __align__(16) unsigned char smem[];
  long long* sk = reinterpret_cast<long long*>(smem);
  int* sv = reinterpret_cast<int*>(sk + SLOTS);
  __shared__ long long s_lo[2], s_hi[2];
  __shared__ int s_cnt[2];
  const int t = threadIdx.x;
  const long long o0 = (long long)blockIdx.x * BLOCK;
  const long long pair = o0 & ~(2 * w - 1);
  const long long d0 = o0 - pair;
  const long long* A = in_k + pair;
  const long long* B = A + w;
  // split search: half h finds how many of A's entries precede diagonal
  // d0 + h*BLOCK, as the count of true predicates A[i] <= B[d - i - 1],
  // which hold exactly for i below the split; HALF probes a round
  const int h = t / HALF, ht = t % HALF;
  const long long dh = d0 + (long long)h * BLOCK;
  if (ht == 0) {
    s_lo[h] = dh > w ? dh - w : 0;
    s_hi[h] = dh < w ? dh : w;
    s_cnt[h] = 0;
  }
  __syncthreads();
  while (s_lo[0] < s_hi[0] || s_lo[1] < s_hi[1]) {
    const long long lo = s_lo[h], hi = s_hi[h], len = hi - lo;
    const long long stride = len <= HALF ? 1 : (len + HALF - 1) / HALF;
    const long long i = lo + (ht + 1) * stride - 1;
    const bool pred = i < hi && A[i] <= B[dh - i - 1];
    const unsigned ballot = __ballot_sync(0xFFFFFFFFu, pred);
    if ((t & 31) == 0) atomicAdd(&s_cnt[h], __popc(ballot));
    __syncthreads();  // the counts are complete
    // the true probes are the first c: the split lies after the c-th probe
    // and, unless every probe was true, at or before the (c+1)-th
    const long long c = s_cnt[h];
    const long long new_lo = lo + c * stride;
    const long long new_hi = c < len / stride ? new_lo + stride - 1 : hi;
    __syncthreads();  // every thread has read this round's state
    if (ht == 0) {
      s_lo[h] = new_lo;
      s_hi[h] = new_hi;
      s_cnt[h] = 0;
    }
    __syncthreads();
  }
  const long long i0 = s_lo[0], i1 = s_lo[1];
  const int na = (int)(i1 - i0);
  const long long j0 = d0 - i0;
  const int* Av = in_v + pair;
  const int* Bv = Av + w;
#pragma unroll
  for (int x = 0; x < ITEMS; ++x) {
    const int e = t + x * THREADS;
    const bool from_a = e < na;
    const long long g = from_a ? i0 + e : j0 + (e - na);
    sk[slot(e)] = from_a ? A[g] : B[g];
    sv[slot(e)] = from_a ? Av[g] : Bv[g];
  }
  __syncthreads();
  long long k[ITEMS];
  int v[ITEMS];
  merge_items(sk, sv, 0, na, na, BLOCK - na, t * ITEMS, k, v);
  __syncthreads();
  regs_to_smem(sk, sv, k, v);
  __syncthreads();
#pragma unroll
  for (int x = 0; x < ITEMS; ++x) {
    const int e = t + x * THREADS;
    out_k[o0 + e] = sk[slot(e)];
    out_v[o0 + e] = sv[slot(e)];
  }
}

constexpr int MAX_DEVICES = 64;

// Opts both kernels in to SMEM bytes of dynamic shared memory (above 48 KiB
// only after this; a refused launch never runs), once per device and
// process rather than on every call.
cudaError_t opt_in() {
  static std::atomic<bool> done[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  err = cudaFuncSetAttribute(block_sort, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(merge_pass, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err == cudaSuccess && dev < MAX_DEVICES) done[dev].store(true, std::memory_order_release);
  return err;
}

}  // namespace

// Entries a CTA sorts in shared memory: for tile > this, the wrapper passes
// a scratch buffer of n entries.
extern "C" int bitonic_sort_block() { return BLOCK; }

// Sorts (keys, vals) tile by tile into (out_keys, out_vals), out of place. n
// is a positive multiple of tile, tile a power of two; scratch_keys and
// scratch_vals hold n entries where tile > BLOCK and may be null otherwise.
// Returns the first launch error, after which nothing more is launched;
// *launches is the number of kernels queued before it.
extern "C" int bitonic_sort_tiles(const void* keys, const void* vals,
                                  void* out_keys, void* out_vals,
                                  void* scratch_keys, void* scratch_vals,
                                  long long n, long long tile, void* stream,
                                  int* launches) {
  *launches = 0;
  cudaError_t err = opt_in();
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  int passes = 0;
  for (long long w = BLOCK; w < tile; w <<= 1) ++passes;
  long long* bk[2] = {(long long*)out_keys, (long long*)scratch_keys};
  int* bv[2] = {(int*)out_vals, (int*)scratch_vals};
  int cur = passes & 1;  // the block sort's target, so the last pass ends in out
  const int span = tile < BLOCK ? (int)tile : BLOCK;
  block_sort<<<(unsigned)((n + BLOCK - 1) / BLOCK), THREADS, SMEM, s>>>(
      (const long long*)keys, (const int*)vals, bk[cur], bv[cur], n, span);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ++*launches;
  for (long long w = BLOCK; w < tile; w <<= 1) {
    merge_pass<<<(unsigned)(n / BLOCK), THREADS, SMEM, s>>>(bk[cur], bv[cur], bk[cur ^ 1],
                                                           bv[cur ^ 1], w);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ++*launches;
    cur ^= 1;
  }
  return (int)cudaSuccess;
}
