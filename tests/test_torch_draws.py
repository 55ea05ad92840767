"""The ``fused_ingest`` kernel's draws, replayed in numpy.

The CUDA kernel computes a chunk's randomness and step-1 selects in
registers (``csrc/threefry.cuh``, ``csrc/fused_ingest.cu``) instead of
reading them from the hoisted ``core.bulk._chunk_randomness``. A CUDA kernel
cannot run here, so this file replays its per-element arithmetic in numpy
uint32/uint64 (the batch-key chain, the counter (0, i), ``x0 ^ x1`` and
``x0 << 32 | x1``, the int64 randint span arithmetic with its wrapping
products, the uniform mantissa, the reservoir counts and selects) and holds
it against the hoisted draws. Then the kernel route's plain version is held
against the JAX scan of ``bulk_update_all`` on the same adversarial chunks:
a stream length above 2^32 (spans wider than 32 bits), the fold-in counter
wrapping at 2^32, batches with n_valid = 0 and a fresh state whose first
batch is empty (totals = 0)."""
import numpy as np
import pytest

import repro  # noqa: F401  -- enables x64
import jax
import jax.numpy as jnp
import torch

from repro.core.state import init_state as jax_init_state
from repro.kernels import ref as kref
from repro_torch import rng
from repro_torch.core.bulk import _chunk_randomness, bulk_update_chunk, chunk_draws
from repro_torch.core.state import init_state

U32, U64 = np.uint32, np.uint64
FIELDS = ("f1", "chi", "f2", "has_f3")


def _rotl(x, r):
    return (x << U32(r)) | (x >> U32(32 - r))


def threefry(key, x0, x1):
    """The kernel's ``threefry::block`` on uint32 arrays (wrapping adds)."""
    k0, k1 = U32(key[0]), U32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ U32(0x1BD11BDA))
    with np.errstate(over="ignore"):  # uint32 scalars warn where arrays wrap silently
        x0 = np.asarray(x0, U32) + ks[0]
        x1 = np.asarray(x1, U32) + ks[1]
        for i in range(5):
            for r in ((13, 15, 26, 6), (17, 29, 16, 24))[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + U32(i + 1)
    return x0, x1


def _key(x0, x1):
    return (U32(np.asarray(x0).item()), U32(np.asarray(x1).item()))


def replay_batch(key, step, m_before, n_valid, r):
    """Batch ``step``'s draws and selects for estimators 0..r-1, as the kernel
    computes them: (t, replace, idx, coin, phi_hi, phi_lo)."""
    bk = _key(*threefry(key, 0, step & 0xFFFFFFFF))  # fold_in
    k1, k2 = _key(*threefry(bk, 0, 0)), _key(*threefry(bk, 0, 1))  # bulk_update_all's split
    t_hi, t_lo = _key(*threefry(k1, 0, 0)), _key(*threefry(k1, 0, 1))  # randint64's split
    k_coin, k_phi = _key(*threefry(k2, 0, 0)), _key(*threefry(k2, 0, 1))  # step 2's split
    p_hi, p_lo = _key(*threefry(k_phi, 0, 0)), _key(*threefry(k_phi, 0, 1))  # randint32's

    i = np.arange(r, dtype=U32)
    zero = np.zeros(r, U32)

    def bits64(k):
        y0, y1 = threefry(k, zero, i)
        return (y0.astype(U64) << U64(32)) | y1.astype(U64)

    def bits32(k):
        y0, y1 = threefry(k, zero, i)
        return y0 ^ y1

    total = m_before + n_valid
    span = U64(max(total, 1))
    mult = U64(1 << 32) % span
    with np.errstate(over="ignore"):
        mult = (mult * mult) % span  # uint64 product, wraps at 2^64
    t = ((bits64(t_hi) % span) * mult + bits64(t_lo) % span) % span
    t = t.astype(np.int64)
    replace = (t >= m_before) & (total > 0)
    idx = np.minimum(np.maximum(t - m_before, 0), max(n_valid - 1, 0))
    coin = ((bits32(k_coin) >> U32(9)) | U32(0x3F800000)).view(np.float32) - np.float32(1.0)
    return t, replace, idx, coin, bits32(p_hi), bits32(p_lo)


CASES = {  # name -> (m_seen, step0, n_valids)
    "fresh_empty_first_batch": (0, 0, [0, 40, 3, 0]),
    "mid_stream": (1000, 17, [40, 40, 1, 40]),
    "int32_crossing": (2**31 - 50, 9, [40, 0, 40, 40]),
    "spans_above_2^32": (2**40 - 3, 123, [40, 0, 40, 7]),
    "step_wraps_at_2^32": (555, 2**32 - 2, [40, 40, 0, 40]),
    "huge_stream": (2**62 + 11, 2**33 + 1, [40, 40, 40, 40]),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("seed", [0, 2**33 + 5])
def test_replayed_draws_match_hoisted(case, seed):
    """The numpy replay of the kernel's arithmetic equals ``_chunk_randomness``
    and ``chunk_draws`` element for element."""
    m_seen, step0, nv = CASES[case]
    r, s, K = 301, 40, len(nv)
    g = np.random.default_rng(len(case))
    Ws = g.integers(0, 60, size=(K, s, 2)).astype(np.int32)
    st = init_state(r)._replace(m_seen=torch.tensor(m_seen, dtype=torch.int64))
    nvt = torch.tensor(nv, dtype=torch.int32)
    key = rng.PRNGKey(seed)
    steps = step0 + torch.arange(K, dtype=torch.int64)
    m_before, totals, t, coin, phi_hi, phi_lo = _chunk_randomness(st, nvt, key, steps)
    replace, w_sel, f1_bpos, coin2, _, _ = chunk_draws(st, torch.from_numpy(Ws), nvt, key, step0)
    kw = (U32(key[0].item()), U32(key[1].item()))
    mb = m_seen
    for k in range(K):
        assert int(m_before[k]) == mb and int(totals[k]) == mb + nv[k]
        rt, rrep, ridx, rcoin, rph, rpl = replay_batch(kw, step0 + k, mb, nv[k], r)
        np.testing.assert_array_equal(t[k].numpy(), rt, err_msg=f"t batch {k}")
        np.testing.assert_array_equal(coin[k].numpy().view(U32), rcoin.view(U32))
        np.testing.assert_array_equal(coin2[k].numpy().view(U32), rcoin.view(U32))
        np.testing.assert_array_equal(phi_hi[k].numpy().view(U32), rph)
        np.testing.assert_array_equal(phi_lo[k].numpy().view(U32), rpl)
        np.testing.assert_array_equal(replace[k].numpy(), rrep)
        np.testing.assert_array_equal(f1_bpos[k].numpy(), np.where(rrep, ridx, -1))
        np.testing.assert_array_equal(w_sel[k].numpy(), Ws[k][ridx])
        mb += nv[k]


def test_replay_sees_wide_spans_and_the_wrap():
    """The cases above reach what they claim: spans above 2^32 (where the
    multiplier's square wraps to 0 at 2^64) and a fold-in counter past
    2^32, which folds in the same key as its low word."""
    span = U64(2**40)
    mult = U64(1 << 32) % span
    with np.errstate(over="ignore"):
        assert (mult * mult) % span == 0
    key = rng.PRNGKey(3)
    assert torch.equal(rng.fold_in(key, 2**32 + 1), rng.fold_in(key, 1))
    kw = (U32(key[0].item()), U32(key[1].item()))
    a = replay_batch(kw, 2**32 + 1, 2**40, 5, 8)
    b = replay_batch(kw, 1, 2**40, 5, 8)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert (a[0] >= 2**32).any()  # t reaches beyond 32 bits


def _jax_state(st):
    js = jax_init_state(st.r)
    return js._replace(f1=jnp.asarray(st.f1.numpy()), chi=jnp.asarray(st.chi.numpy()),
                       f2=jnp.asarray(st.f2.numpy()), has_f3=jnp.asarray(st.has_f3.numpy()),
                       m_seen=jnp.int64(int(st.m_seen)))


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_route_vs_jax_on_adversarial_chunks(case):
    """The kernel route on CPU tensors (the kernel's plain version) over a
    populated state set to each case's stream length and first step,
    against the JAX scan of bulk_update_all."""
    m_seen, step0, nv = CASES[case]
    r, s, K = 257, 40, len(nv)
    g = np.random.default_rng(7)
    Ws = g.integers(0, 50, size=(K, s, 2)).astype(np.int32)
    Ws[0, 0] = [2, 2]  # a self-loop
    Ws[1, 1] = Ws[1, 0]  # a duplicate edge in one batch
    warm = g.integers(0, 50, size=(2, s, 2)).astype(np.int32)
    key = rng.PRNGKey(11)
    st = bulk_update_chunk(init_state(r), torch.from_numpy(warm), torch.tensor([s, s]), key,
                           backend="scan")
    if m_seen:  # the fresh case keeps a fresh state, so its first totals are 0
        st = st._replace(m_seen=torch.tensor(m_seen, dtype=torch.int64))
    else:
        st = init_state(r)
    want = kref.fused_ingest_ref(_jax_state(st), jnp.asarray(Ws), jnp.asarray(np.array(nv, np.int32)),
                                 jax.random.PRNGKey(11), step0)
    got = bulk_update_chunk(st, torch.from_numpy(Ws), torch.tensor(nv, dtype=torch.int32), key,
                            step0, backend="kernel")
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert int(got.m_seen) == int(want.m_seen) == m_seen + sum(nv)
