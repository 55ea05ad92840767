// segscan: inclusive segmented scan of 32-bit values (flag = segment start),
// over one of two monoids: wrapping uint32 sums, or the signed int32 maximum.
//
// Replaces the Pallas kernel repro/kernels/segscan.py::_segscan_kernel
// (wrapper segscan), and, for the maximum, the plain running maximum of
// repro_torch/primitives/segscan.py::segmented_cummax that the structure
// build's stability patch ran through torch.cummax. The TPU kernel carries
// the running value from one grid step to the next in an SMEM cell, which is
// correct only because a TPU grid runs in order. CTAs on Hopper run
// concurrently and in no order, so this is a single-pass chained scan with
// decoupled look-back (Merrill and Garland, 2016) over the monoid
//     (v1, f1) + (v2, f2) = (f2 ? v2 : v1 op v2, f1 | f2):
//   * each CTA takes its tile index from an atomic counter, not from
//     blockIdx.x, so a tile only waits on tiles whose CTAs already run (no
//     deadlock on predecessors that are not resident);
//   * it loads its tile of TILE = 512 * 16 entries with 16-byte loads (16
//     values and 16 flags a thread), reduces each thread's items in
//     registers, scans across the CTA with warp shuffles and one shared
//     step, and publishes the tile's aggregate;
//   * status and value share one 64-bit word (status in the high half),
//     written by one release store and read by acquire loads, so no reader
//     sees a status with another value;
//   * a tile holding a start flag publishes its inclusive prefix at once
//     (from its last flag on, the aggregate is the prefix); it looks back
//     only if its first entry is not a flag;
//   * look-back: warp 0 reads the 32 nearest predecessors' words, waits
//     while any is unpublished, and reduces back to the nearest one holding
//     a prefix (an aggregate word carries no flag, so op alone combines).
// The tile counter and the status words are zeroed by a cudaMemsetAsync on
// the same stream before the kernel (not counted as a kernel).
//
// Bound on the H100: memory. The least traffic is the values and flags read
// once and the result written once (9 bytes an entry); the status words add
// 8 bytes per 8192 entries. Sums wrap at 2^32 like the reference's int32
// adds (done in uint32 here); the maximum compares signed int32, identity
// INT32_MIN.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int ITEMS = 16;     // a multiple of 16 (one 16-byte load of flags each), at most 32
constexpr int MIN_CTAS = 1;   // the launch bound's CTAs an SM
constexpr int TILE = THREADS * ITEMS;
constexpr int WARPS = THREADS / 32;
constexpr unsigned STATUS_AGGREGATE = 1u;  // the tile's own aggregate, no flag in it
constexpr unsigned STATUS_PREFIX = 2u;     // the inclusive prefix at the tile's end

struct SumOp {
  using T = unsigned;
  static __device__ __forceinline__ T identity() { return 0u; }
  static __device__ __forceinline__ T apply(T a, T b) { return a + b; }
};

struct MaxOp {
  using T = int;
  static __device__ __forceinline__ T identity() { return INT32_MIN; }
  static __device__ __forceinline__ T apply(T a, T b) { return a > b ? a : b; }
};

template <class Op>
struct Pair {
  typename Op::T v;
  int f;
};

template <class Op>
__device__ __forceinline__ Pair<Op> combine(Pair<Op> a, Pair<Op> b) {
  return {b.f ? b.v : Op::apply(a.v, b.v), a.f | b.f};
}

template <class Op>
__device__ __forceinline__ Pair<Op> shfl_up(Pair<Op> x, int d) {
  return {(typename Op::T)__shfl_up_sync(0xffffffffu, (unsigned)x.v, d),
          __shfl_up_sync(0xffffffffu, x.f, d)};
}

__device__ __forceinline__ unsigned long long load_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

template <class Op>
__device__ __forceinline__ void publish(unsigned long long* word, unsigned status,
                                        typename Op::T v) {
  store_release(word, ((unsigned long long)status << 32) | (unsigned)v);
}

template <class Op>
__global__ void __launch_bounds__(THREADS, MIN_CTAS)
    segscan_kernel(const typename Op::T* __restrict__ values,
                   const unsigned char* __restrict__ flags, long long n,
                   typename Op::T* __restrict__ out, unsigned long long* status,
                   unsigned* counter, int vectorised) {
  using T = typename Op::T;
  __shared__ int tile_sh;
  __shared__ T warp_v[WARPS];
  __shared__ int warp_f[WARPS];
  __shared__ T carry_sh;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) tile_sh = (int)atomicAdd(counter, 1u);
  __syncthreads();
  const int tile = tile_sh;
  const long long base = (long long)tile * TILE;
  const long long first = base + (long long)threadIdx.x * ITEMS;

  // this thread's ITEMS entries; bit i of fl set where item i starts a segment
  T v[ITEMS];
  unsigned fl = 0;
  if (vectorised && base + TILE <= n) {
    const uint4* vp = reinterpret_cast<const uint4*>(values + first);
#pragma unroll
    for (int j = 0; j < ITEMS / 4; ++j) {
      uint4 w = __ldg(vp + j);
      v[4 * j] = (T)w.x;
      v[4 * j + 1] = (T)w.y;
      v[4 * j + 2] = (T)w.z;
      v[4 * j + 3] = (T)w.w;
    }
#pragma unroll
    for (int j = 0; j < ITEMS / 16; ++j) {
      const uint4 fw = __ldg(reinterpret_cast<const uint4*>(flags + first) + j);
      const unsigned words[4] = {fw.x, fw.y, fw.z, fw.w};
#pragma unroll
      for (int i = 0; i < 16; ++i)
        fl |= (unsigned)(((words[i >> 2] >> (8 * (i & 3))) & 0xffu) != 0u) << (16 * j + i);
    }
  } else {
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const long long g = first + i;
      v[i] = g < n ? values[g] : Op::identity();
      fl |= (g < n && flags[g] != 0) ? 1u << i : 0u;
    }
  }

  Pair<Op> agg{Op::identity(), 0};
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) agg = combine<Op>(agg, {v[i], (int)((fl >> i) & 1u)});

  // CTA-wide scan of the thread aggregates
  Pair<Op> inc = agg;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    Pair<Op> p = shfl_up<Op>(inc, d);
    if (lane >= d) inc = combine<Op>(p, inc);
  }
  if (lane == 31) {
    warp_v[warp] = inc.v;
    warp_f[warp] = inc.f;
  }
  __syncthreads();
  if (warp == 0) {
    Pair<Op> w = lane < WARPS ? Pair<Op>{warp_v[lane], warp_f[lane]}
                              : Pair<Op>{Op::identity(), 0};
#pragma unroll
    for (int d = 1; d < WARPS; d <<= 1) {
      Pair<Op> p = shfl_up<Op>(w, d);
      if (lane >= d) w = combine<Op>(p, w);
    }
    if (lane < WARPS) {
      warp_v[lane] = w.v;  // inclusive over warps
      warp_f[lane] = w.f;
    }
  }
  __syncthreads();
  Pair<Op> excl = shfl_up<Op>(inc, 1);
  if (lane == 0) excl = {Op::identity(), 0};
  if (warp > 0) excl = combine<Op>({warp_v[warp - 1], warp_f[warp - 1]}, excl);

  // publish the tile, then look back for the carry entering it
  if (warp == 0) {
    const Pair<Op> total{warp_v[WARPS - 1], warp_f[WARPS - 1]};
    const bool has_prefix = tile == 0 || total.f;
    if (lane == 0)
      publish<Op>(status + tile, has_prefix ? STATUS_PREFIX : STATUS_AGGREGATE, total.v);
    T carry = Op::identity();
    // thread 0's first item is the tile's first entry; a flag there needs no carry
    const bool first_flagged = __shfl_sync(0xffffffffu, fl & 1u, 0) != 0u;
    if (tile > 0 && !first_flagged) {
      for (int end = tile - 1;; end -= 32) {
        const int t = end - lane;
        unsigned long long word = (unsigned long long)STATUS_PREFIX << 32 |
                                  (unsigned)Op::identity();
        if (t >= 0) {
          do {
            word = load_acquire(status + t);
          } while ((unsigned)(word >> 32) == 0u);
        }
        const unsigned prefixes =
            __ballot_sync(0xffffffffu, (unsigned)(word >> 32) == STATUS_PREFIX);
        const int stop = prefixes ? __ffs(prefixes) - 1 : 31;
        T x = lane <= stop ? (T)(unsigned)word : Op::identity();
#pragma unroll
        for (int d = 16; d > 0; d >>= 1)
          x = Op::apply(x, (T)__shfl_xor_sync(0xffffffffu, (unsigned)x, d));
        carry = Op::apply(carry, x);
        if (prefixes) break;
      }
      if (lane == 0 && !total.f)
        publish<Op>(status + tile, STATUS_PREFIX, Op::apply(carry, total.v));
    }
    if (lane == 0) carry_sh = carry;
  }
  __syncthreads();

  // the value entering this thread's first item, then the items themselves
  T run = excl.f ? excl.v : Op::apply(carry_sh, excl.v);
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    run = (fl >> i) & 1u ? v[i] : Op::apply(run, v[i]);
    v[i] = run;
  }
  if (vectorised && base + TILE <= n) {
    uint4* op = reinterpret_cast<uint4*>(out + first);
#pragma unroll
    for (int j = 0; j < ITEMS / 4; ++j)
      op[j] = make_uint4((unsigned)v[4 * j], (unsigned)v[4 * j + 1], (unsigned)v[4 * j + 2],
                         (unsigned)v[4 * j + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < ITEMS; ++i)
      if (first + i < n) out[first + i] = v[i];
  }
}

template <class Op>
int run(const void* values, const void* flags, long long n, void* out, void* scratch,
        void* stream, int* launches) {
  *launches = 0;
  cudaStream_t s = (cudaStream_t)stream;
  const long long n_tiles = (n + TILE - 1) / TILE;
  // scratch: the tile counter (8 bytes, for alignment), then a status word a tile
  unsigned* counter = (unsigned*)scratch;
  unsigned long long* status = (unsigned long long*)scratch + 1;
  cudaError_t err = cudaMemsetAsync(scratch, 0, (size_t)(n_tiles + 1) * 8, s);
  if (err != cudaSuccess) return (int)err;
  const int vectorised =
      (((uintptr_t)values | (uintptr_t)flags | (uintptr_t)out) & 15u) == 0u;
  segscan_kernel<Op><<<(unsigned)n_tiles, THREADS, 0, s>>>(
      (const typename Op::T*)values, (const unsigned char*)flags, n,
      (typename Op::T*)out, status, counter, vectorised);
  err = cudaGetLastError();
  *launches = err == cudaSuccess;  // the kernel; the memset is not counted
  return (int)err;
}

}  // namespace

extern "C" int segscan_tile_size() { return TILE; }

// Inclusive segmented sum of int32 values (wrapping), flags one byte each.
// scratch: (n_tiles + 1) * 8 bytes. *launches: the kernels queued (1).
extern "C" int segscan(const void* values, const void* flags, long long n,
                       void* out, void* scratch, void* stream, int* launches) {
  return run<SumOp>(values, flags, n, out, scratch, stream, launches);
}

// The same scan over the signed int32 maximum.
extern "C" int segscan_max(const void* values, const void* flags, long long n,
                           void* out, void* scratch, void* stream, int* launches) {
  return run<MaxOp>(values, flags, n, out, scratch, stream, launches);
}
