// segment_sum: out[k, :] = sum of values[i, :] over the rows i with
// segment_ids[i] == k; ids outside [0, num_segments) are dropped.
//
// Replaces the Pallas kernel repro/kernels/segment_sum.py::_segsum_kernel
// (wrapper segment_sum_kernel). The TPU kernel contracts onehot(s - o)^T @ V
// per (output block, value block) on the MXU, because a TPU has no fast
// random scatter: n * m * d multiply-adds, about 2.6e13 at the local scheme's
// full size (n = 6,291,456 rows into m = 4,194,304 bins). Hopper scatters
// through L2 atomics cheaply, so this kernel zero-fills the output and issues
// one atomicAdd(double *) (native since sm_60) per (row in range, column).
//
// One cooperative launch, its grid as large as occupancy lets every CTA be
// resident:
//   1. each thread loads its ids into registers with 16-byte loads (up to
//      HELD of them), and meanwhile zero-fills its slice of out with 16-byte
//      stores, so the read of the ids overlaps the fill;
//   2. grid.sync();
//   3. it adds the rows it holds whose id is in range, reading a row's
//      values only for those rows; ids beyond what the grid holds (and a
//      ragged or unaligned rest) are read after the barrier, BATCH loads a
//      thread in flight at once (one at a time, their latencies would
//      queue up: 15 of them a thread at full size).
// At full size the 33.5 MB output fits the 50 MB L2, so the atomics land on
// lines the fill just wrote. d = 1 has its own path; one tenant divides nothing.
//
// A bank of T tenants (the reference runs its kernel under jax.vmap over
// tenants): values (T, n, d) and ids (T, n) flattened to T * n rows, out
// (T, m, d). Row i belongs to tenant i / n, and its id is checked against
// [0, m) before it is offset into that tenant's bins, so an out-of-range id
// is dropped within its tenant and never lands in a neighbour's bins. The
// division is skipped for T = 1, the one-tenant call. Still one launch.
//
// Contract: the order of the atomic adds is not fixed, so the result is exact
// (and equal to any other summation order) only where every value and every
// partial sum is an integer below 2^53 in magnitude. That is the only case on
// the port's path: the local scheme's attribution sums integer-valued
// coarse estimates chi * m_seen.
//
// Bound on the H100: memory. The least traffic is the ids read once, the
// values of the rows in range read once and the output written once.
// Contention on one bin (every row to one segment) serialises its atomics;
// that case is kept correct, not fast.
//
// n == 0 and num_segments == 0 are answered by the wrapper without a launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int HELD = 8;   // 16-byte words of ids (4 ids each) a thread holds
constexpr int BATCH = 4;  // words (or ids) a thread reads at once after the barrier
constexpr int MIN_CTAS = 4;  // the launch bound's CTAs an SM
static_assert(BATCH <= HELD, "the batches after the barrier reuse the held registers");

// The bank's shape: tenants, and the rows of each (n = tenants * per).
struct Bank {
  long long tenants, per;
};

template <bool D1>
__device__ __forceinline__ void add_row(const double* __restrict__ values, long long row,
                                        int seg, int d, int m, const Bank& bank, double* out) {
  if (seg < 0 || seg >= m) return;
  const long long bin = (bank.tenants == 1 ? 0 : (row / bank.per) * m) + seg;
  if (D1) {
    atomicAdd(out + bin, values[row]);
  } else {
    const double* v = values + row * d;
    double* o = out + bin * d;
    for (int c = 0; c < d; ++c) atomicAdd(o + c, v[c]);
  }
}

// MIN_CTAS = 4: at most 64 registers a thread, so that 4 CTAs (1024
// threads) an SM are resident and the grid holds about 4.3M ids in registers
template <bool D1>
__global__ void __launch_bounds__(THREADS, MIN_CTAS)
    segment_sum_kernel(const double* __restrict__ values, const int* __restrict__ ids,
                       long long n, int d, int m, Bank bank, double* __restrict__ out,
                       long long words, long long held_words) {
  const long long threads = (long long)gridDim.x * THREADS;
  const long long me = (long long)blockIdx.x * THREADS + threadIdx.x;
  const int4* ids4 = reinterpret_cast<const int4*>(ids);
  const int4 none = make_int4(-1, -1, -1, -1);
  // 1. ids into registers (word j of this thread: j * threads + me), then
  //    the zero-fill while they arrive
  int4 w[HELD];
#pragma unroll
  for (int j = 0; j < HELD; ++j) {
    const long long q = j * threads + me;
    w[j] = q < held_words ? __ldg(ids4 + q) : none;
  }
  const long long cells = bank.tenants * m * d;
  double2* out2 = reinterpret_cast<double2*>(out);
  for (long long i = me; i < cells / 2; i += threads) out2[i] = make_double2(0.0, 0.0);
  if (me == 0 && (cells & 1)) out[cells - 1] = 0.0;
  cg::this_grid().sync();
  // 3. the rows held, then the rest from memory, BATCH loads in flight at
  //    once so that their latencies overlap
#pragma unroll
  for (int j = 0; j < HELD; ++j) {
    const long long row = 4 * (j * threads + me);
    add_row<D1>(values, row, w[j].x, d, m, bank, out);
    add_row<D1>(values, row + 1, w[j].y, d, m, bank, out);
    add_row<D1>(values, row + 2, w[j].z, d, m, bank, out);
    add_row<D1>(values, row + 3, w[j].w, d, m, bank, out);
  }
  for (long long q0 = held_words + me; q0 < words; q0 += BATCH * threads) {
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const long long q = q0 + k * threads;
      w[k] = q < words ? __ldg(ids4 + q) : none;
    }
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const long long row = 4 * (q0 + k * threads);
      add_row<D1>(values, row, w[k].x, d, m, bank, out);
      add_row<D1>(values, row + 1, w[k].y, d, m, bank, out);
      add_row<D1>(values, row + 2, w[k].z, d, m, bank, out);
      add_row<D1>(values, row + 3, w[k].w, d, m, bank, out);
    }
  }
  // the rows past the last whole word (all of them where ids is not 16-byte
  // aligned), one id a thread, BATCH at once
  for (long long r0 = 4 * words + me; r0 < n; r0 += BATCH * threads) {
    int id[BATCH];
#pragma unroll
    for (int k = 0; k < BATCH; ++k) id[k] = r0 + k * threads < n ? __ldg(ids + r0 + k * threads) : -1;
#pragma unroll
    for (int k = 0; k < BATCH; ++k) add_row<D1>(values, r0 + k * threads, id[k], d, m, bank, out);
  }
}

}  // namespace

// values (tenants, per, d) and ids (tenants, per); out (tenants, m, d) must
// be 16-byte aligned (the wrapper allocates it), for the fill's 16-byte
// stores. *launches: the kernels queued (1).
extern "C" int segment_sum(const void* values, const void* ids, long long tenants,
                           long long per, long long d, long long m, void* out, void* stream,
                           int* launches) {
  const long long n = tenants * per;
  *launches = 0;
  cudaStream_t s = (cudaStream_t)stream;
  const bool d1 = d == 1;
  const void* kernel = d1 ? (const void*)segment_sum_kernel<true>
                          : (const void*)segment_sum_kernel<false>;
  // resident CTAs of each variant on each device, asked once (an
  // occupancy query costs microseconds of host time a call)
  static int resident[2][64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (resident[d1][dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0);
    if (err != cudaSuccess) return (int)err;
    resident[d1][dev] = per_sm * sms;
  }
  // as many CTAs as the ids held in registers or the zero-fill can use, at
  // most what can be resident at once (a cooperative launch's limit)
  const long long words = ((uintptr_t)ids & 15u) == 0u ? n / 4 : 0;
  const long long hold_threads = (words + HELD - 1) / HELD;
  const long long fill_threads = (tenants * m * d + 1) / 2;
  long long blocks = (std::max(hold_threads, fill_threads) + THREADS - 1) / THREADS;
  const long long most = resident[d1][dev];
  if (blocks > most) blocks = most;
  if (blocks < 1) blocks = 1;
  long long held_words = blocks * THREADS * HELD;
  if (held_words > words) held_words = words;
  const double* v = (const double*)values;
  const int* i = (const int*)ids;
  int di = (int)d, mi = (int)m;
  double* o = (double*)out;
  long long w = words, rows = n;
  Bank bank{tenants, per};
  void* args[] = {(void*)&v, (void*)&i, (void*)&rows, (void*)&di, (void*)&mi, (void*)&bank,
                  (void*)&o, (void*)&w, (void*)&held_words};
  err = cudaLaunchCooperativeKernel(kernel, dim3((unsigned)blocks), dim3(THREADS), args, 0, s);
  if (err == cudaSuccess) err = cudaGetLastError();
  *launches = err == cudaSuccess;
  return (int)err;
}
