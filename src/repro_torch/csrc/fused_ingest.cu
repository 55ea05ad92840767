// fused_ingest: apply a K-batch chunk to the estimator state in one kernel.
//
// Replaces the Pallas kernel repro/kernels/fused_ingest.py::_fused_ingest_kernel
// (wrapper fused_ingest). Contract: bit-identical to the scan of
// bulk_update_all over the same chunk (repro_torch/kernels/ref.py ::
// fused_ingest_ref), given the hoisted randomness and the K rank structures.
//
// Design: one thread per estimator. Its state (f1, chi, f2, has_f3) stays in
// registers across the K batches and is read and written once per chunk.
// The TPU kernel answers every search by a dense compare-reduce of its
// estimator tile against the whole per-batch structure and reads payloads by
// one-hot selects, because a TPU has no fast gather; at the paper's batch of
// 2^20 edges a structure holds 2^21 int64 keys (16 MiB) and that O(r * s)
// form cannot carry over. Here each search is a binary search over the
// structure in global memory (the three structures of one batch, 40 MiB,
// mostly stay in the 50 MB L2 while all estimators walk them) and each
// payload is one gather at the found index.
//
// Per batch and estimator: step-1 replace; Q1 rank/degree as four lower
// bounds over key_desc; chi update; coin < chi+ / max(chi, 1) in IEEE float
// (the division is a correctly rounded '/', never __fdividef, and the file is
// built without --use_fast_math); phi by the uint32 randint span arithmetic;
// the Q2 decode as one lower bound over key_rank; the step-3 closing probe as
// a lower and an upper bound over ekey under the p3 > f2_bpos rule.
//
// Bound on the H100: the least traffic is the state and the per-(batch,
// estimator) inputs read once, the structures read once and the state written
// once. What it waits on is latency: about 6 * log2(2s) dependent L2 loads per
// estimator per batch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ long long pack2(int hi, int lo) {
  // (hi << 32) | lo with lo sign-extended, exactly as the reference's pack2
  return (long long)(((unsigned long long)(long long)hi << 32) |
                     (unsigned long long)(long long)lo);
}

__device__ __forceinline__ int lower_bound(const long long* __restrict__ a,
                                           int n, long long x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = lo + ((hi - lo) >> 1);
    if (a[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ int upper_bound(const long long* __restrict__ a,
                                           int lo, int n, long long x) {
  int hi = n;
  while (lo < hi) {
    int mid = lo + ((hi - lo) >> 1);
    if (a[mid] <= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void fused_ingest_kernel(
    const int* __restrict__ f1, const int* __restrict__ chi,
    const int* __restrict__ f2, const unsigned char* __restrict__ has_f3,
    const long long* __restrict__ key_desc,
    const long long* __restrict__ key_rank, const int* __restrict__ src,
    const int* __restrict__ dst, const int* __restrict__ pos,
    const long long* __restrict__ ekey, const int* __restrict__ epos,
    const unsigned char* __restrict__ replace, const int* __restrict__ w_sel,
    const int* __restrict__ f1_bpos, const float* __restrict__ coin,
    const unsigned* __restrict__ phi_hi, const unsigned* __restrict__ phi_lo,
    int* __restrict__ f1_out, int* __restrict__ chi_out,
    int* __restrict__ f2_out, unsigned char* __restrict__ has_f3_out, int r,
    int n_batches, int s) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= r) return;
  const int s2 = 2 * s;
  int u = f1[2 * i], v = f1[2 * i + 1];
  int c = chi[i];
  int a = f2[2 * i], b = f2[2 * i + 1];
  bool h = has_f3[i] != 0;

  for (int k = 0; k < n_batches; ++k) {
    const long long o = (long long)k * r + i;
    // --- step 1: reservoir selects (decisions precomputed) ---
    if (replace[o]) {
      u = w_sel[2 * o];
      v = w_sel[2 * o + 1];
      c = 0;
      a = -1;
      b = -1;
      h = false;
    }
    const int f1b = f1_bpos[o];
    const bool have_f1 = u >= 0;

    // --- step 2: Q1 rank/degree (lt only) ---
    const long long* kd = key_desc + (long long)k * s2;
    const int hi_u = lower_bound(kd, s2, pack2(u, (s - 1) - f1b));
    const int hi_v = lower_bound(kd, s2, pack2(v, (s - 1) - f1b));
    const int lo_u = lower_bound(kd, s2, pack2(u, 0));
    const int lo_v = lower_bound(kd, s2, pack2(v, 0));
    const int ld = have_f1 ? hi_u - lo_u : 0;
    const int rd = have_f1 ? hi_v - lo_v : 0;
    const int chi_plus = ld + rd;
    const int chi_new = c + chi_plus;
    const float p_new = (float)chi_plus / fmaxf((float)chi_new, 1.0f);
    bool take = have_f1 && chi_plus > 0 && coin[o] < p_new;

    // --- phi ~ randint(0, max(chi+, 1)) replayed on the raw bits ---
    const unsigned span = (unsigned)(chi_plus > 1 ? chi_plus : 1);
    unsigned m = 65536u % span;
    m = (m * m) % span;
    const unsigned off = ((phi_hi[o] % span) * m + (phi_lo[o] % span)) % span;
    const int phi = (int)off;

    // --- Q2 decode via the (src, rank) naming system ---
    const int t_src = phi < ld ? u : v;
    const int t_rank = phi < ld ? phi : phi - ld;
    const long long qk = pack2(t_src, t_rank);
    const long long* kr = key_rank + (long long)k * s2;
    const int lt = lower_bound(kr, s2, qk);
    const int j = lt < s2 - 1 ? lt : s2 - 1;
    const bool found = lt < s2 && kr[j] == qk;
    const long long row = (long long)k * s2 + j;
    take = take && found;
    int f2_bpos = -1;
    if (take) {
      const int ca = src[row], cb = dst[row];
      a = ca < cb ? ca : cb;
      b = ca < cb ? cb : ca;
      f2_bpos = pos[row];
      h = false;
    }
    c = chi_new;

    // --- step 3: closing-edge probe ---
    const bool have_wedge = u >= 0 && a >= 0;
    const bool u_shared = (u == a) || (u == b);
    const int o1 = u_shared ? v : u;
    const bool a_shared = (a == u) || (a == v);
    const int o2 = a_shared ? b : a;
    const long long qe = pack2(o1 < o2 ? o1 : o2, o1 < o2 ? o2 : o1);
    const long long* ek = ekey + (long long)k * s;
    const int lt3 = lower_bound(ek, s, qe);
    const int le3 = upper_bound(ek, lt3, s, qe);
    const int p3 = epos[(long long)k * s + (le3 > 0 ? le3 - 1 : 0)];
    h = h || (have_wedge && le3 > lt3 && p3 > f2_bpos);
  }
  f1_out[2 * i] = u;
  f1_out[2 * i + 1] = v;
  chi_out[i] = c;
  f2_out[2 * i] = a;
  f2_out[2 * i + 1] = b;
  has_f3_out[i] = h ? 1 : 0;
}

}  // namespace

extern "C" int fused_ingest(const void* f1, const void* chi, const void* f2,
                            const void* has_f3, const void* key_desc,
                            const void* key_rank, const void* src,
                            const void* dst, const void* pos, const void* ekey,
                            const void* epos, const void* replace,
                            const void* w_sel, const void* f1_bpos,
                            const void* coin, const void* phi_hi,
                            const void* phi_lo, void* f1_out, void* chi_out,
                            void* f2_out, void* has_f3_out, long long r,
                            long long n_batches, long long s, void* stream,
                            int* launches) {
  *launches = 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((r + threads - 1) / threads);
  fused_ingest_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)f1, (const int*)chi, (const int*)f2,
      (const unsigned char*)has_f3, (const long long*)key_desc,
      (const long long*)key_rank, (const int*)src, (const int*)dst,
      (const int*)pos, (const long long*)ekey, (const int*)epos,
      (const unsigned char*)replace, (const int*)w_sel, (const int*)f1_bpos,
      (const float*)coin, (const unsigned*)phi_hi, (const unsigned*)phi_lo,
      (int*)f1_out, (int*)chi_out, (int*)f2_out, (unsigned char*)has_f3_out,
      (int)r, (int)n_batches, (int)s);
  const cudaError_t err = cudaGetLastError();
  *launches = err == cudaSuccess;
  return (int)err;
}
