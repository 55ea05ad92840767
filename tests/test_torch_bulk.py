"""The port's bulk update and estimate against the JAX reference: the same
(state, Ws, n_valids, key, step0) gives the identical state on every field,
on every ingest backend, with ragged tails, self-loops, duplicate edges,
empty batches and K in {1, 2, 4}; the median-of-means matches for even and
odd group counts."""
import numpy as np
import pytest

import repro  # noqa: F401  -- enables x64
import jax
import jax.numpy as jnp
import torch

from repro.core import bulk as jbulk
from repro.core.estimate import effective_groups as jax_effective_groups
from repro.core.estimate import estimate as jax_estimate
from repro.core.state import EstimatorState as JaxState
from repro.core.state import init_state as jax_init_state
from repro_torch import rng
from repro_torch.core import bulk
from repro_torch.core.estimate import effective_groups, estimate, median
from repro_torch.core.state import EstimatorState, init_state
from repro_torch.primitives.ingest import INGEST_BACKENDS, resolve_ingest_backend

T = torch.from_numpy
FIELDS = EstimatorState._fields
jax_scan = jax.jit(jbulk._bulk_update_chunk_scan)
jax_all = jax.jit(jbulk.bulk_update_all)


def _stream(K, s, seed, n_valids=None):
    g = np.random.default_rng(seed)
    Ws = g.integers(0, max(3 * s // 2, 4), size=(K, s, 2)).astype(np.int32)
    Ws[0, 0] = [1, 1]  # self-loop
    if s >= 3:
        Ws[-1, 2] = Ws[-1, 1]  # duplicate edge within a batch
        Ws[-1, 1] = Ws[-1, 1][::-1]  # and its reversed copy
    nv = g.integers(1, s + 1, K).astype(np.int32) if n_valids is None else np.array(n_valids, np.int32)
    return Ws, nv


def _state_from_jax(js) -> EstimatorState:
    return EstimatorState(*(T(np.array(getattr(js, f))) for f in FIELDS))


def _assert_same(js, ts, msg=""):
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(js, f)), getattr(ts, f).numpy(),
                                      err_msg=f"{msg} {f}")


def _warm_state(r, seed):
    """A mid-stream state (some f1/f2 set, closed wedges) from the JAX side."""
    Ws, nv = _stream(3, 16, seed + 100, [16, 16, 9])
    return jax_scan(jax_init_state(r), jnp.asarray(Ws), jnp.asarray(nv), jax.random.PRNGKey(seed), 0)


@pytest.mark.parametrize("search", ["eager", "kernel"])
@pytest.mark.parametrize("s,n_valid", [(8, 8), (8, 0), (24, 13), (64, 64)])
def test_bulk_update_all(search, s, n_valid):
    r = 300
    js0 = _warm_state(r, s)
    Ws, _ = _stream(1, s, s + n_valid)
    key = jax.random.fold_in(jax.random.PRNGKey(7), 3)
    want = jax_all(js0, jnp.asarray(Ws[0]), jnp.int32(n_valid), key)
    got = bulk.bulk_update_all(_state_from_jax(js0), T(Ws[0]), n_valid,
                               rng.fold_in(rng.PRNGKey(7), 3), search)
    _assert_same(want, got)


@pytest.mark.parametrize("backend", ["scan", "fused", "kernel"])
@pytest.mark.parametrize("K,s,n_valids", [
    (1, 16, None), (2, 12, [12, 5]), (4, 20, [20, 0, 7, 20]), (4, 6, [6, 6, 6, 1]),
])
def test_bulk_update_chunk_every_backend(backend, K, s, n_valids):
    r = 257
    js0 = _warm_state(r, K * s)
    Ws, nv = _stream(K, s, K + s, n_valids)
    want = jax_scan(js0, jnp.asarray(Ws), jnp.asarray(nv), jax.random.PRNGKey(11), 6)
    got = bulk.bulk_update_chunk(_state_from_jax(js0), T(Ws), T(nv), rng.PRNGKey(11), 6,
                                 backend=backend)
    _assert_same(want, got, backend)


def test_chunk_equals_batches_and_empty_batch_is_noop_on_state_draws():
    """K fused batches equal K single-batch updates; an n_valid = 0 batch
    leaves f1/f2/chi/has_f3 untouched (it only advances the RNG cursor)."""
    r, s = 128, 10
    Ws, nv = _stream(3, s, 5, [10, 0, 4])
    st = init_state(r)
    chunk = bulk.bulk_update_chunk(st, T(Ws), T(nv), rng.PRNGKey(2), 0, backend="fused")
    seq = st
    for i in range(3):
        seq = bulk.bulk_update_all(seq, T(Ws[i]), int(nv[i]), rng.fold_in(rng.PRNGKey(2), i))
        if i == 0:
            after_first = seq
        if i == 1:
            for f in ("f1", "chi", "f2", "has_f3"):
                assert torch.equal(getattr(seq, f), getattr(after_first, f))
    for f in FIELDS:
        assert torch.equal(getattr(chunk, f), getattr(seq, f))


def test_ingest_backend_switch():
    assert INGEST_BACKENDS == ("auto", "scan", "fused", "kernel")
    assert resolve_ingest_backend("auto", torch.device("cpu")) == "fused"
    assert resolve_ingest_backend("auto", torch.device("cuda")) == "kernel"
    with pytest.raises(ValueError):
        resolve_ingest_backend("pallas", torch.device("cpu"))


@pytest.mark.parametrize("r,groups", [(512, 9), (512, 7), (4096, 9), (4095, 9), (100, 1000), (64, 64)])
def test_estimate_even_and_odd_group_counts(r, groups):
    g = np.random.default_rng(r)
    chi = g.integers(0, 50, r).astype(np.int32)
    has = g.random(r) < 0.3
    js = JaxState(jnp.zeros((r, 2), jnp.int32), jnp.asarray(chi), jnp.zeros((r, 2), jnp.int32),
                  jnp.asarray(has), jnp.int64(987654))
    ts = EstimatorState(torch.zeros((r, 2), dtype=torch.int32), T(chi),
                        torch.zeros((r, 2), dtype=torch.int32), T(has), torch.tensor(987654))
    assert effective_groups(r, groups) == jax_effective_groups(r, groups)
    want = float(jax_estimate(js, groups))
    got = float(estimate(ts, groups))
    # f64 means of integer coarse estimates summed in another order
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_median_averages_the_middle_pair():
    x = torch.tensor([4.0, 1.0, 3.0, 2.0], dtype=torch.float64)
    assert float(median(x)) == 2.5 == float(jnp.median(jnp.asarray(x.numpy())))
    assert float(median(x[:3])) == 3.0
