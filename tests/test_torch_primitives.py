"""The port's primitives and rankAll against the JAX reference on the same
numpy inputs: pack2, the stable sort, the segmented scans, multisearch on
both backends, and every RankStructure field of rank_all / rank_all_chunk
(the kernel route except its padding tails, which its contract leaves
unspecified)."""
import numpy as np
import pytest

import repro  # noqa: F401  -- enables x64
import jax
import jax.numpy as jnp
import torch

from repro.core import rank as jrank
from repro.primitives import segscan as jseg
from repro.primitives.search import multisearch_bounds as jax_bounds
from repro.primitives.sort import pack2 as jax_pack2
from repro.primitives.sort import sort_by_key as jax_sort_by_key
from repro_torch.core.rank import rank_all, rank_all_chunk
from repro_torch.primitives import segscan as tseg
from repro_torch.primitives.search import (
    MULTISEARCH_BACKENDS,
    multisearch_bounds,
    multisearch_lt,
    resolve_multisearch_backend,
)
from repro_torch.primitives.sort import pack2, sort_by_key, unpack2

INF64 = np.iinfo(np.int64).max
T = torch.from_numpy
jax_rank_all = jax.jit(jrank.rank_all)
jax_rank_all_chunk = jax.jit(jrank.rank_all_chunk)
J_SCANS = {name: jax.jit(getattr(jseg, name)) for name in (
    "segment_starts", "segmented_iota", "segmented_cummax", "segmented_sum_scan")}


def test_pack2_keeps_sign_extension():
    hi = np.array([0, 1, 5, -1, 7, 2**31 - 1], np.int32)
    lo = np.array([0, 2, -1, 3, 2**31 - 1, 0], np.int32)
    np.testing.assert_array_equal(np.asarray(jax_pack2(jnp.asarray(hi), jnp.asarray(lo))),
                                  pack2(T(hi), T(lo)).numpy())
    h, l = unpack2(pack2(T(hi[:2]), T(lo[:2])))
    np.testing.assert_array_equal(h.numpy(), hi[:2])
    np.testing.assert_array_equal(l.numpy(), lo[:2])


@pytest.mark.parametrize("n", [1, 50, 1000])
def test_sort_by_key_is_stable(n):
    g = np.random.default_rng(n)
    keys = g.integers(0, max(n // 10, 2), n).astype(np.int64)
    vals = np.arange(n, dtype=np.int32)
    want = jax_sort_by_key(jnp.asarray(keys), jnp.asarray(vals))
    got = sort_by_key(T(keys), T(vals))
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("n,p", [(1, 0.5), (37, 0.0), (500, 0.05), (500, 1.0), (4099, 0.01)])
def test_segmented_scans(n, p):
    g = np.random.default_rng(n)
    keys = np.sort(g.integers(0, max(int(n * p), 1), n)).astype(np.int64)
    flags = g.random(n) < p
    vals = g.integers(-50, 50, n).astype(np.int32)
    np.testing.assert_array_equal(np.asarray(J_SCANS["segment_starts"](jnp.asarray(keys))),
                                  tseg.segment_starts(T(keys)).numpy())
    np.testing.assert_array_equal(np.asarray(J_SCANS["segmented_iota"](jnp.asarray(flags))),
                                  tseg.segmented_iota(T(flags)).numpy())
    np.testing.assert_array_equal(
        np.asarray(J_SCANS["segmented_cummax"](jnp.asarray(vals), jnp.asarray(flags))),
        tseg.segmented_cummax(T(vals), T(flags)).numpy())
    np.testing.assert_array_equal(
        np.asarray(J_SCANS["segmented_sum_scan"](jnp.asarray(vals), jnp.asarray(flags))),
        tseg.segmented_sum_scan(T(vals), T(flags)).numpy())


def test_segmented_sum_scan_wraps_int32():
    vals = np.full(8, 2**30, np.int32)
    flags = np.zeros(8, bool)
    np.testing.assert_array_equal(
        np.asarray(J_SCANS["segmented_sum_scan"](jnp.asarray(vals), jnp.asarray(flags))),
        tseg.segmented_sum_scan(T(vals), T(flags)).numpy())


@pytest.mark.parametrize("backend", ["eager", "kernel", "auto"])
@pytest.mark.parametrize("n,q", [(0, 5), (5, 0), (1, 7), (300, 257), (64, 1000)])
def test_multisearch_bounds(backend, n, q):
    g = np.random.default_rng(n * 1000 + q)
    keys = np.sort(np.concatenate([g.integers(0, 40, n - n // 4), np.full(n // 4, INF64)])).astype(np.int64)
    qs = np.concatenate([g.integers(-3, 45, max(q - 2, 0)), [INF64, 0][:q]]).astype(np.int64)[:q]
    lt, le = jax_bounds(jnp.asarray(keys), jnp.asarray(qs))
    tlt, tle = multisearch_bounds(T(keys), T(qs), backend)
    assert tlt.dtype == torch.int32 and tle.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(lt), tlt.numpy())
    np.testing.assert_array_equal(np.asarray(le), tle.numpy())
    np.testing.assert_array_equal(np.asarray(lt), multisearch_lt(T(keys), T(qs), backend).numpy())


def test_multisearch_backend_switch():
    assert resolve_multisearch_backend("auto", torch.device("cpu")) == "eager"
    assert resolve_multisearch_backend("auto", torch.device("cuda")) == "kernel"
    assert MULTISEARCH_BACKENDS == ("auto", "eager", "kernel")
    with pytest.raises(ValueError):
        resolve_multisearch_backend("pallas", torch.device("cpu"))


def _batch(s, n_vert, seed):
    g = np.random.default_rng(seed)
    W = g.integers(0, n_vert, size=(s, 2)).astype(np.int32)
    if s >= 3:
        W[0] = [2, 2]  # self-loop
        W[2] = W[1]  # duplicate edge
    return W


@pytest.mark.parametrize("s,n_valid", [(1, 1), (8, 0), (8, 5), (64, 64), (100, 37)])
def test_rank_all_every_field(s, n_valid):
    W = _batch(s, max(s // 2, 3), s + n_valid)
    want = jax_rank_all(jnp.asarray(W), jnp.int32(n_valid))
    for nv in (n_valid, torch.tensor(n_valid, dtype=torch.int32)):
        got = rank_all(T(W), nv)
        for f in want._fields:
            np.testing.assert_array_equal(np.asarray(getattr(want, f)), getattr(got, f).numpy(),
                                          err_msg=f)


@pytest.mark.parametrize("s,n_valid", [(1, 1), (8, 0), (8, 5), (64, 64), (100, 37)])
def test_rank_all_kernel_switch(s, n_valid):
    """``rank_all(use_kernels=True)`` (ranks by segscan, here its plain
    version) equals the eager build and the JAX reference in every field."""
    W = _batch(s, max(s // 2, 3), s + n_valid)
    want = jax_rank_all(jnp.asarray(W), jnp.int32(n_valid))
    eager = rank_all(T(W), n_valid)
    got = rank_all(T(W), n_valid, use_kernels=True)
    for f in want._fields:
        np.testing.assert_array_equal(getattr(eager, f).numpy(), getattr(got, f).numpy(),
                                      err_msg=f)
        np.testing.assert_array_equal(np.asarray(getattr(want, f)), getattr(got, f).numpy(),
                                      err_msg=f)


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("K,s", [(1, 6), (3, 40), (2, 64)])
def test_rank_all_chunk(use_kernels, K, s):
    g = np.random.default_rng(K * s)
    Ws = np.stack([_batch(s, max(s // 2, 3), K * s + k) for k in range(K)])
    nv = g.integers(0, s + 1, K).astype(np.int32)
    nv[0] = s
    want = jax_rank_all_chunk(jnp.asarray(Ws), jnp.asarray(nv))  # the eager reference
    got = rank_all_chunk(T(Ws), T(nv), use_kernels=use_kernels)
    for f in want._fields:
        w, t = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert w.shape == t.shape, f
        if f in ("key_desc", "key_rank", "ekey") or not use_kernels:
            np.testing.assert_array_equal(w, t, err_msg=f)
            continue
        for k in range(K):  # payloads up to the padding tail
            m = nv[k] if f == "epos" else 2 * nv[k]
            np.testing.assert_array_equal(w[k, :m], t[k, :m], err_msg=f"{f} batch {k}")
