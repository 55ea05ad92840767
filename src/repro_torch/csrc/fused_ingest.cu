// fused_ingest: apply a K-batch chunk to the estimator state, drawing the
// chunk's randomness inside the kernel.
//
// Replaces the Pallas kernel repro/kernels/fused_ingest.py::_fused_ingest_kernel
// (wrapper fused_ingest). Contract: bit-identical to the scan of
// bulk_update_all over the same chunk (repro_torch/kernels/ref.py ::
// fused_ingest_ref), given the K rank structures, the chunk's edges, the
// stream key and the chunk's first step.
//
// The TPU kernel reads every random draw from HBM, hoisted out of the scan,
// and answers each search by a dense compare-reduce of its estimator tile
// against the whole per-batch structure (a TPU has no fast gather). Here:
//
//   * Draws in registers. Element i of a jax draw is one threefry block of
//     the counter (0, i) (threefry.cuh), so a thread computes its
//     estimator's five draws of batch k itself: the reservoir's int64
//     randint t (two 64-bit words, jax's span arithmetic in native unsigned
//     64-bit), the coin (uniform) and phi's two 32-bit words. The batch's
//     keys (fold_in(key, step0 + k), then the splits of bulk_update_all,
//     step2_level2 and randint) and its reservoir counts (m_before, totals:
//     prefix sums of n_valids over m_seen) are derived once per CTA into
//     shared memory. The step-1 selects (replace, the selected edge, f1_bpos)
//     follow from t. No (K, r) draw or select is ever materialised.
//   * Searches from shared memory (search.cuh). Each CTA holds a sample of
//     SAMPLE keys of each of the batch's three sorted structures (key_desc,
//     key_rank, ekey), searches it first and finishes in an L2 window of
//     step - 1 keys. The paired bounds share one descent: Q1's (lo_u, hi_u)
//     and (lo_v, hi_v), step 3's (lt, le). Each thread carries EST = 2
//     estimators, so Q1 keeps four descents in flight. A search whose
//     answer is masked (no f1, no take, no wedge) loads nothing.
//   * Occupancy and L1 over sample size (tools/fused_sweep.py on the H100):
//     the samples take 24 KiB a CTA and registers are capped at 64, so four
//     CTAs fit an SM and leave up to 156 KB of its 256 KB to the L1 cache,
//     which can hold the upper levels of the L2 windows. Larger samples cost more L1
//     than they save probes (2048 keys at four CTAs an SM ran 1.5x slower);
//     two CTAs an SM (4096 keys, 91 registers) ran 1.4x slower.
//   * Batch-major order: one launch per batch on a persistent grid. While
//     every estimator walks batch k, only that batch's structures (about
//     40 MiB at s = 2^20) compete for the 50 MB L2, and each CTA loads its
//     samples once per batch. The state moves through HBM once per batch
//     (about 88 MB at r = 2^21, 26 us at 3.35 TB/s); launch k > 0 updates
//     the output in place.
//
// A bank of T tenants (the reference runs its kernel under jax.vmap over
// tenants): the persistent grid walks the (tenant, estimator tile) pairs
// tenant-major. A CTA working on tenant t's tile reads its state rows, its
// batch's structures and edges, its counts, its key and its first step
// (step0s[t], on the device), and nothing of another tenant's; it derives
// the batch's keys and loads the samples again only where its tenant
// changes. Every CTA advances at about the same pace, so the grid works on
// about one tenant at a time and the batch-major L2 argument below holds
// for a bank too. (A grid with a tenant axis ran all four tenants at once,
// four batches' structures competing for the L2, and took 1.58x four
// one-tenant calls at the full shape on an NVIDIA H100 80GB HBM3 at 700 W,
// chip_smoke.py.) The batch loop stays one launch a batch for every T;
// T = 1 is the one-tenant call, tile for tile.
//
// Per batch and estimator: step-1 replace; Q1 rank/degree as two pairs of
// lower bounds over key_desc; chi update; coin < chi+ / max(chi, 1) in IEEE
// float (the division is a correctly rounded '/', never __fdividef, and the
// file is built without --use_fast_math); phi by the uint32 randint span
// arithmetic; the Q2 decode as one lower bound over key_rank; the step-3
// closing probe as a lower and an upper bound over ekey under the
// p3 > f2_bpos rule.
//
// Bound on the H100: the least traffic is the state read and written once,
// each batch's structures and edges read once (0.12 ms at the full shape);
// the threefry blocks (5 per estimator and batch, about 80 32-bit
// operations each) take less. What it waits on is the latency of the
// searches' dependent loads: about 10 shared-memory probes, then 11 probes
// in L1 or L2 per descent.

#include <cuda_runtime.h>

#include <atomic>

#include "search.cuh"
#include "threefry.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int EST = 2;        // estimators a thread carries
constexpr int SAMPLE = 1024;  // keys in each of the three shared samples
constexpr int MIN_CTAS = 4;   // CTAs an SM: caps registers at 65536 / (MIN_CTAS * THREADS)
constexpr size_t SMEM = 3 * SAMPLE * sizeof(long long);

__device__ __forceinline__ long long pack2(int hi, int lo) {
  // (hi << 32) | lo with lo sign-extended, exactly as the reference's pack2
  return (long long)(((unsigned long long)(long long)hi << 32) |
                     (unsigned long long)(long long)lo);
}

// What every estimator of one batch draws from.
struct Batch {
  uint2 t_hi, t_lo;      // randint64's two word keys (split of bulk_update_all's k1)
  uint2 coin;            // step2_level2's coin key
  uint2 phi_hi, phi_lo;  // randint32's two word keys (split of the phi key)
  unsigned long long m_before, span, mult;  // span = max(totals, 1), mult = (2^32 % span)^2 % span
  int n_valid;
  bool any;  // totals > 0
};

// The keys of batch k: fold_in(key, step), split into bulk_update_all's
// (k1, k2); k1 feeds randint64 (its own split into the hi and lo word
// keys), k2 splits into step 2's (coin, phi) keys, and phi's randint32
// splits its key once more.
__device__ Batch batch_keys(const long long* key, long long step, const int* n_valids,
                            const long long* m_seen, int k) {
  Batch b;
  const uint2 root = make_uint2((unsigned)key[0], (unsigned)key[1]);
  const uint2 bk = threefry::fold_in(root, (unsigned)step);
  const uint2 k1 = threefry::split(bk, 0), k2 = threefry::split(bk, 1);
  b.t_hi = threefry::split(k1, 0);
  b.t_lo = threefry::split(k1, 1);
  b.coin = threefry::split(k2, 0);
  const uint2 kphi = threefry::split(k2, 1);
  b.phi_hi = threefry::split(kphi, 0);
  b.phi_lo = threefry::split(kphi, 1);
  long long m = *m_seen;
  for (int j = 0; j < k; ++j) m += n_valids[j];
  const long long total = m + n_valids[k];
  b.m_before = (unsigned long long)m;
  b.n_valid = n_valids[k];
  b.any = total > 0;
  b.span = (unsigned long long)(total > 0 ? total : 1);
  const unsigned long long mult = (1ull << 32) % b.span;
  b.mult = (mult * mult) % b.span;  // wraps at 2^64, as jax's uint64 product
  return b;
}

// The state's tenant rows, and batch k's structures and edges, of one
// tenant of the bank (every array of Bank is tenant 0's).
struct Tenant {
  const int *f1, *chi, *f2;
  const unsigned char* has_f3;
  int *f1_out, *chi_out, *f2_out;
  unsigned char* has_f3_out;
  const long long *kd, *kr, *ek;
  const int *src, *dst, *pos, *epos, *W;
};

struct Bank {
  Tenant zero;  // tenant 0, batch k
  const int* n_valids;  // (T, K)
  const long long *m_seen, *key, *step0s;  // (T,), (T, 2), (T,)
  int T, K;
  // the global index of the state's first estimator: a shard of a sharded
  // plan holds estimators [e0, e0 + r) and draws counters e0 + e, its slice
  // of the full-r draw; the state itself is indexed by e
  long long e0;
};

__device__ __forceinline__ Tenant tenant_rows(const Bank& bank, long long t, int r, int s) {
  const long long rows = t * r, arcs = t * bank.K * 2LL * s, edges = t * bank.K * (long long)s;
  const Tenant& z = bank.zero;
  return {z.f1 + 2 * rows, z.chi + rows, z.f2 + 2 * rows, z.has_f3 + rows,
          z.f1_out + 2 * rows, z.chi_out + rows, z.f2_out + 2 * rows, z.has_f3_out + rows,
          z.kd + arcs, z.kr + arcs, z.ek + edges, z.src + arcs, z.dst + arcs, z.pos + arcs,
          z.epos + edges, z.W + 2 * edges};
}

// Batch k of the chunk for every estimator of every tenant. The state
// inputs may alias the outputs (launches k > 0 update in place).
__global__ void __launch_bounds__(THREADS, MIN_CTAS)
fused_batch_kernel(const Bank bank, int k, int r, int s) {
  extern __shared__ __align__(16) long long smem[];
  __shared__ Batch shared_batch;
  const int s2 = 2 * s;
  const Batch& bt = shared_batch;
  const long long per_cta = (long long)THREADS * EST;
  const long long tiles = (r + per_cta - 1) / per_cta;  // a tenant's estimator tiles
  long long tenant = -1;  // the tenant whose keys and samples are loaded
  search::Sample sd{}, sr{}, se{};
  for (long long w = blockIdx.x; w < bank.T * tiles; w += gridDim.x) {
    const long long t = w / tiles;
    // the tenant's arrays, from the parameters again each tile rather than
    // held in registers across tiles
    const Tenant tr = tenant_rows(bank, t, r, s);
    if (t != tenant) {  // uniform across the CTA
      tenant = t;
      __syncthreads();  // every thread is done with the old samples
      if (threadIdx.x == 0)
        shared_batch = batch_keys(bank.key + 2 * t, bank.step0s[t] + k,
                                  bank.n_valids + t * bank.K, bank.m_seen + t, k);
      sd = search::load_sample<THREADS>(smem, SAMPLE, tr.kd, s2);
      sr = search::load_sample<THREADS>(smem + SAMPLE, SAMPLE, tr.kr, s2);
      se = search::load_sample<THREADS>(smem + 2 * SAMPLE, SAMPLE, tr.ek, s);
      __syncthreads();
    }
    const long long base = (w - t * tiles) * per_cta;
    const int* f1 = tr.f1;  // not restrict: launches k > 0 read the outputs
    const int* chi = tr.chi;
    const int* f2 = tr.f2;
    const unsigned char* has_f3 = tr.has_f3;
    int* f1_out = tr.f1_out;
    int* chi_out = tr.chi_out;
    int* f2_out = tr.f2_out;
    unsigned char* has_f3_out = tr.has_f3_out;
    const long long* __restrict__ kd = tr.kd;
    const long long* __restrict__ kr = tr.kr;
    const long long* __restrict__ ek = tr.ek;
    const int* __restrict__ src = tr.src;
    const int* __restrict__ dst = tr.dst;
    const int* __restrict__ pos = tr.pos;
    const int* __restrict__ epos = tr.epos;
    const int* __restrict__ W = tr.W;
    int i[EST], u[EST], v[EST], c[EST], a[EST], b[EST], f1b[EST];
    bool live[EST], h[EST];
    float coin[EST];
    unsigned ph[EST], pl[EST];

    // --- state, draws and step 1: the reservoir over E u W ---
#pragma unroll
    for (int j = 0; j < EST; ++j) {
      i[j] = (int)(base + threadIdx.x + (long long)j * THREADS);
      live[j] = i[j] < r;
      const int e = live[j] ? i[j] : 0;
      u[j] = live[j] ? f1[2 * e] : -1;
      v[j] = live[j] ? f1[2 * e + 1] : -1;
      c[j] = live[j] ? chi[e] : 0;
      a[j] = live[j] ? f2[2 * e] : -1;
      b[j] = live[j] ? f2[2 * e + 1] : -1;
      h[j] = live[j] && has_f3[e] != 0;
      // t ~ randint64(0, max(totals, 1)): jax's two-word span arithmetic;
      // every draw's counter is the estimator's global index
      const unsigned ctr = (unsigned)(bank.e0 + e);
      const unsigned long long w_hi = threefry::bits64(bt.t_hi, ctr);
      const unsigned long long w_lo = threefry::bits64(bt.t_lo, ctr);
      const unsigned long long t = ((w_hi % bt.span) * bt.mult + w_lo % bt.span) % bt.span;
      const bool replace = live[j] && bt.any && t >= bt.m_before;
      long long d = (long long)t - (long long)bt.m_before;
      d = d < 0 ? 0 : d;
      const long long cap = bt.n_valid > 1 ? bt.n_valid - 1 : 0;
      const int idx = (int)(d < cap ? d : cap);
      f1b[j] = replace ? idx : -1;
      if (replace) {
        u[j] = W[2 * idx];
        v[j] = W[2 * idx + 1];
        c[j] = 0;
        a[j] = b[j] = -1;
        h[j] = false;
      }
      coin[j] = threefry::uniform(bt.coin, ctr);
      ph[j] = threefry::bits32(bt.phi_hi, ctr);
      pl[j] = threefry::bits32(bt.phi_lo, ctr);
    }

    // --- step 2, Q1: rank/degree of both f1 endpoints, one descent a pair ---
    long long x1[2 * EST], x2[2 * EST];
    bool act[2 * EST];
    int lo[2 * EST], hi[2 * EST];
#pragma unroll
    for (int j = 0; j < EST; ++j) {
      const int off = (s - 1) - f1b[j];
      x1[2 * j] = pack2(u[j], 0);
      x2[2 * j] = pack2(u[j], off);
      x1[2 * j + 1] = pack2(v[j], 0);
      x2[2 * j + 1] = pack2(v[j], off);
      act[2 * j] = act[2 * j + 1] = u[j] >= 0;
    }
    search::two_level<2 * EST, false>(sd, kd, s2, x1, x2, act, lo, hi);

    long long qk[EST];
    bool take[EST];
    int chi_new[EST], f2_bpos[EST];
#pragma unroll
    for (int j = 0; j < EST; ++j) {
      const bool have_f1 = u[j] >= 0;
      const int ld = have_f1 ? hi[2 * j] - lo[2 * j] : 0;
      const int rd = have_f1 ? hi[2 * j + 1] - lo[2 * j + 1] : 0;
      const int chi_plus = ld + rd;
      chi_new[j] = c[j] + chi_plus;
      const float p_new = (float)chi_plus / fmaxf((float)chi_new[j], 1.0f);
      take[j] = have_f1 && chi_plus > 0 && coin[j] < p_new;
      // phi ~ randint32(0, max(chi+, 1)) on the raw words
      const unsigned span = (unsigned)(chi_plus > 1 ? chi_plus : 1);
      unsigned m = 65536u % span;
      m = (m * m) % span;
      const int phi = (int)(((ph[j] % span) * m + (pl[j] % span)) % span);
      const int t_src = phi < ld ? u[j] : v[j];
      const int t_rank = phi < ld ? phi : phi - ld;
      qk[j] = pack2(t_src, t_rank);
      f2_bpos[j] = -1;
    }

    // --- Q2: decode (src, rank) to the new level-2 edge ---
    int lt2[EST], lt2b[EST];
    search::two_level<EST, false>(sr, kr, s2, qk, qk, take, lt2, lt2b);
#pragma unroll
    for (int j = 0; j < EST; ++j) {
      if (take[j]) {
        const int row = lt2[j] < s2 - 1 ? lt2[j] : s2 - 1;
        if (lt2[j] < s2 && kr[row] == qk[j]) {
          const int ca = src[row], cb = dst[row];
          a[j] = ca < cb ? ca : cb;
          b[j] = ca < cb ? cb : ca;
          f2_bpos[j] = pos[row];
          h[j] = false;
        }
      }
      c[j] = chi_new[j];
    }

    // --- step 3: the closing-edge probe, (lt, le) in one descent ---
    long long qe[EST];
    bool wedge[EST];
#pragma unroll
    for (int j = 0; j < EST; ++j) {
      wedge[j] = u[j] >= 0 && a[j] >= 0;
      const int o1 = (u[j] == a[j] || u[j] == b[j]) ? v[j] : u[j];
      const int o2 = (a[j] == u[j] || a[j] == v[j]) ? b[j] : a[j];
      qe[j] = pack2(o1 < o2 ? o1 : o2, o1 < o2 ? o2 : o1);
    }
    int lt3[EST], le3[EST];
    search::two_level<EST, true>(se, ek, s, qe, qe, wedge, lt3, le3);
#pragma unroll
    for (int j = 0; j < EST; ++j) {
      if (wedge[j] && le3[j] > lt3[j]) h[j] = h[j] || epos[le3[j] - 1] > f2_bpos[j];
      if (live[j]) {
        f1_out[2 * i[j]] = u[j];
        f1_out[2 * i[j] + 1] = v[j];
        chi_out[i[j]] = c[j];
        f2_out[2 * i[j]] = a[j];
        f2_out[2 * i[j] + 1] = b[j];
        has_f3_out[i[j]] = h[j] ? 1 : 0;
      }
    }
  }
}

std::atomic<long long> resident[search::MAX_DEVICES];

}  // namespace

// One launch per batch for all T tenants; *launches is the number of
// kernels queued (K, or fewer on an error). T, r, K and s are at least 1.
// step0s holds T int64 first steps on the device: tenant t's batch k draws
// from fold_in(key[t], step0s[t] + k). Estimator e draws counter e0 + e
// (e0 >= 0, e0 + r below 2^32), the same for every tenant.
extern "C" int fused_ingest(const void* f1, const void* chi, const void* f2,
                            const void* has_f3, const void* key_desc,
                            const void* key_rank, const void* src,
                            const void* dst, const void* pos, const void* ekey,
                            const void* epos, const void* Ws, const void* n_valids,
                            const void* m_seen, const void* key, void* f1_out,
                            void* chi_out, void* f2_out, void* has_f3_out,
                            const void* step0s, long long tenants, long long r,
                            long long n_batches, long long s, long long e0, void* stream,
                            int* launches) {
  *launches = 0;
  long long ctas = 0;
  cudaError_t err = search::resident_ctas(fused_batch_kernel, THREADS, SMEM, resident, &ctas);
  if (err != cudaSuccess) return (int)err;
  const long long tiles =
      tenants * ((r + (long long)THREADS * EST - 1) / ((long long)THREADS * EST));
  const unsigned blocks = (unsigned)(tiles < ctas ? tiles : ctas);
  for (long long k = 0; k < n_batches; ++k) {
    const bool first = k == 0;
    const Tenant zero{
        (const int*)(first ? f1 : f1_out), (const int*)(first ? chi : chi_out),
        (const int*)(first ? f2 : f2_out),
        (const unsigned char*)(first ? has_f3 : has_f3_out), (int*)f1_out, (int*)chi_out,
        (int*)f2_out, (unsigned char*)has_f3_out, (const long long*)key_desc + k * 2 * s,
        (const long long*)key_rank + k * 2 * s, (const long long*)ekey + k * s,
        (const int*)src + k * 2 * s, (const int*)dst + k * 2 * s, (const int*)pos + k * 2 * s,
        (const int*)epos + k * s, (const int*)Ws + k * 2 * s};
    const Bank bank{zero, (const int*)n_valids, (const long long*)m_seen,
                    (const long long*)key, (const long long*)step0s, (int)tenants,
                    (int)n_batches, e0};
    fused_batch_kernel<<<blocks, THREADS, SMEM, (cudaStream_t)stream>>>(bank, (int)k, (int)r,
                                                                        (int)s);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ++*launches;
  }
  return 0;
}
