// segscan: inclusive segmented sum scan of int32 values (flag = segment start).
//
// Replaces the Pallas kernel repro/kernels/segscan.py::_segscan_kernel
// (wrapper segscan). The TPU kernel carries the running sum from one grid
// step to the next in an SMEM cell, which is correct only because a TPU grid
// runs in order. CTAs on Hopper run concurrently and in no order, so this is
// a three-pass scan over the segmented-sum monoid
//     (v1, f1) + (v2, f2) = (f2 ? v2 : v1 + v2, f1 | f2):
//   1. segscan_tiles: each CTA scans its tile of TILE = 4 * 1024 entries
//      (four per thread in registers, then warp shuffles and one shared-memory
//      step across warps), writes the tile-local result, the tile's aggregate
//      and the offset of its first flag;
//   2. segscan_carries: one CTA scans the tile aggregates into the exclusive
//      carry entering each tile;
//   3. segscan_fixup: adds each tile's carry to its entries before the tile's
//      first flag.
//
// Bound on the H100: memory. The least traffic is the values and flags read
// once and the result written once (9 bytes an entry); passes 1 and 3 move
// about twice that, and pass 2 touches 9 bytes per 4096 entries.
// Sums wrap at 2^32 like the reference's int32 adds (done in uint32 here).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 1024;
constexpr int ITEMS = 4;
constexpr int TILE = THREADS * ITEMS;
constexpr int WARPS = THREADS / 32;

struct Pair {
  unsigned v;
  int f;
};

__device__ __forceinline__ Pair combine(Pair a, Pair b) {
  Pair r;
  r.v = b.f ? b.v : a.v + b.v;
  r.f = a.f | b.f;
  return r;
}

// Inclusive scan of one Pair per thread across the whole CTA; returns the
// thread's exclusive prefix and writes the CTA total to *total.
__device__ Pair block_exclusive_scan(Pair x, Pair* total) {
  __shared__ Pair warp_sums[WARPS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  Pair inc = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    Pair p;
    p.v = __shfl_up_sync(0xffffffffu, inc.v, d);
    p.f = __shfl_up_sync(0xffffffffu, inc.f, d);
    if (lane >= d) inc = combine(p, inc);
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    Pair w = lane < WARPS ? warp_sums[lane] : Pair{0u, 0};
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      Pair p;
      p.v = __shfl_up_sync(0xffffffffu, w.v, d);
      p.f = __shfl_up_sync(0xffffffffu, w.f, d);
      if (lane >= d) w = combine(p, w);
    }
    if (lane < WARPS) warp_sums[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  Pair excl;
  excl.v = __shfl_up_sync(0xffffffffu, inc.v, 1);
  excl.f = __shfl_up_sync(0xffffffffu, inc.f, 1);
  if (lane == 0) excl = Pair{0u, 0};
  if (warp > 0) excl = combine(warp_sums[warp - 1], excl);
  *total = warp_sums[WARPS - 1];
  __syncthreads();  // warp_sums is reused by the next call
  return excl;
}

__global__ void segscan_tiles(const int* __restrict__ values,
                              const unsigned char* __restrict__ flags,
                              long long n, int* __restrict__ out,
                              unsigned* __restrict__ tile_v,
                              int* __restrict__ tile_f,
                              int* __restrict__ tile_first) {
  __shared__ int first_flag;
  if (threadIdx.x == 0) first_flag = TILE;
  __syncthreads();
  const long long base = (long long)blockIdx.x * TILE + threadIdx.x * ITEMS;
  unsigned v[ITEMS];
  int f[ITEMS];
  Pair agg{0u, 0};
  int my_first = TILE;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    long long g = base + i;
    v[i] = g < n ? (unsigned)values[g] : 0u;
    f[i] = g < n ? (flags[g] != 0) : 1;
    if (f[i] && my_first == TILE) my_first = threadIdx.x * ITEMS + i;
    agg = combine(agg, Pair{v[i], f[i]});
  }
  if (my_first < TILE) atomicMin(&first_flag, my_first);
  Pair total;
  Pair run = block_exclusive_scan(agg, &total);
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    run = combine(run, Pair{v[i], f[i]});
    long long g = base + i;
    if (g < n) out[g] = (int)run.v;
  }
  if (threadIdx.x == 0) {
    tile_v[blockIdx.x] = total.v;
    tile_f[blockIdx.x] = total.f;
    tile_first[blockIdx.x] = first_flag;
  }
}

__global__ void segscan_carries(const unsigned* __restrict__ tile_v,
                                const int* __restrict__ tile_f, int n_tiles,
                                unsigned* __restrict__ carry) {
  Pair running{0u, 0};
  for (int start = 0; start < n_tiles; start += THREADS) {
    int t = start + threadIdx.x;
    Pair x = t < n_tiles ? Pair{tile_v[t], tile_f[t]} : Pair{0u, 0};
    Pair total;
    Pair excl = block_exclusive_scan(x, &total);
    if (t < n_tiles) carry[t] = combine(running, excl).v;
    running = combine(running, total);
  }
}

__global__ void segscan_fixup(int* __restrict__ out, long long n,
                              const unsigned* __restrict__ carry,
                              const int* __restrict__ tile_first) {
  const int tile = blockIdx.x + 1;  // tile 0 has no carry
  const int first = tile_first[tile];
  const unsigned c = carry[tile];
  for (int i = threadIdx.x; i < first; i += blockDim.x) {
    long long g = (long long)tile * TILE + i;
    if (g < n) out[g] = (int)((unsigned)out[g] + c);
  }
}

}  // namespace

extern "C" int segscan_tile_size() { return TILE; }

// scratch: n_tiles * (4 + 4 + 4 + 4) bytes, laid out as
// tile_v | tile_f | tile_first | carry.
// *launches: the kernels queued (1 for one tile, else 3).
extern "C" int segscan(const void* values, const void* flags, long long n,
                       void* out, void* scratch, void* stream, int* launches) {
  *launches = 0;
  cudaStream_t s = (cudaStream_t)stream;
  const long long n_tiles = (n + TILE - 1) / TILE;
  unsigned* tile_v = (unsigned*)scratch;
  int* tile_f = (int*)(tile_v + n_tiles);
  int* tile_first = tile_f + n_tiles;
  unsigned* carry = (unsigned*)(tile_first + n_tiles);
  segscan_tiles<<<(unsigned)n_tiles, THREADS, 0, s>>>(
      (const int*)values, (const unsigned char*)flags, n, (int*)out, tile_v,
      tile_f, tile_first);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  *launches = 1;
  if (n_tiles == 1) return (int)err;
  segscan_carries<<<1, THREADS, 0, s>>>(tile_v, tile_f, (int)n_tiles, carry);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  *launches = 2;
  segscan_fixup<<<(unsigned)(n_tiles - 1), 256, 0, s>>>((int*)out, n, carry,
                                                        tile_first);
  err = cudaGetLastError();
  if (err == cudaSuccess) *launches = 3;
  return (int)err;
}
