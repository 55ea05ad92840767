// segment_sum: out[k, :] = sum of values[i, :] over the rows i with
// segment_ids[i] == k; ids outside [0, num_segments) are dropped.
//
// Replaces the Pallas kernel repro/kernels/segment_sum.py::_segsum_kernel
// (wrapper segment_sum_kernel). The TPU kernel contracts onehot(s - o)^T @ V
// per (output block, value block) on the MXU, because a TPU has no fast
// random scatter: n * m * d multiply-adds, about 2.6e13 at the local scheme's
// full size (n = 6,291,456 rows into m = 4,194,304 bins). Hopper scatters
// through L2 atomics cheaply, so this kernel zero-fills the output and gives
// each (row, column) one thread: a bounds check on the row's id, then one
// atomicAdd(double *) (native since sm_60) into its bin.
//
// Contract: the order of the atomic adds is not fixed, so the result is exact
// (and equal to any other summation order) only where every value and every
// partial sum is an integer below 2^53 in magnitude. That is the only case on
// the port's path: the local scheme's attribution sums integer-valued
// coarse estimates chi * m_seen.
//
// Bound on the H100: memory. The least traffic is the ids read once, the
// values of the rows in range read once and the output written once; the
// zero-fill writes the output a second time. Contention on one bin (every row
// to one segment) serialises its atomics; that case is kept correct, not fast.
//
// n == 0 and num_segments == 0 are answered by the wrapper without a launch.

#include <cuda_runtime.h>

namespace {

__global__ void segment_sum_kernel(const double* __restrict__ values,
                                   const int* __restrict__ ids, long long n,
                                   int d, int m, double* __restrict__ out) {
  const long long total = n * (long long)d;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    const long long row = t / d;
    const int seg = ids[row];
    if (seg < 0 || seg >= m) continue;
    atomicAdd(out + (long long)seg * d + (t - row * d), values[t]);
  }
}

}  // namespace

extern "C" int segment_sum(const void* values, const void* ids, long long n,
                           long long d, long long m, void* out, void* stream,
                           int* launches) {
  *launches = 0;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(out, 0, (size_t)(m * d) * sizeof(double), s);
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  long long blocks = (n * d + threads - 1) / threads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride beyond 64 CTAs/SM
  segment_sum_kernel<<<(unsigned)blocks, threads, 0, s>>>(
      (const double*)values, (const int*)ids, n, (int)d, (int)m, (double*)out);
  err = cudaGetLastError();
  *launches = err == cudaSuccess;  // the kernel; the memset is not counted
  return (int)err;
}
