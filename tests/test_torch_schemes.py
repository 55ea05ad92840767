"""The port's schemes against the JAX reference (``repro.core.schemes``):
the vertex hash, the local per-vertex estimate on the reference's XLA and
Pallas-interpret backends, the naive update, the engine under each scheme,
snapshots across schemes and packages, and the CLI's per-vertex line. Inputs
are seeded numpy; every comparison is exact."""
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import repro  # noqa: F401  -- enables x64
import jax
import jax.numpy as jnp
import torch

from repro.core import schemes as jschemes
from repro.core.sequential import local_triangle_counts as jax_local_counts
from repro.core.state import init_state as jax_init_state
from repro.engine import EngineConfig as JaxConfig
from repro.engine import TriangleCountEngine as JaxEngine
from repro.primitives.ingest import ingest_backend, set_ingest_backend
from repro_torch import rng
from repro_torch.core import schemes
from repro_torch.core.sequential import local_triangle_counts
from repro_torch.core.state import EstimatorState, init_state
from repro_torch.data.graph_stream import batches, erdos_renyi_stream, planted_triangle_stream
from repro_torch.engine import EngineConfig, SnapshotMismatch, TriangleCountEngine
from repro_torch.interop import from_jax_snapshot, state_sha256, to_jax_snapshot
from repro_torch.kernels import LAUNCHES

ROOT = pathlib.Path(__file__).resolve().parents[1]
R, S, NV = 512, 64, 900
T = torch.from_numpy


def _edges(seed=0):
    edges, _ = planted_triangle_stream(40, 700, NV, seed=seed)
    return edges  # 820 edges: 12 full batches of 64 and a ragged one of 52


def _local(pools):
    return {"n_vertices": NV, "n_pools": pools}


def _port(K=1, scheme="global", params=None, **kw):
    return TriangleCountEngine(EngineConfig(r=R, batch_size=S, chunk_size=K, seeds=(5,),
                                            scheme=scheme, scheme_params=params,
                                            device="cpu", **kw))


def _jax(K=1, scheme="global", params=None):
    return JaxEngine(JaxConfig(r=R, batch_size=S, chunk_size=K, seeds=(5,),
                               scheme=scheme, scheme_params=params))


@pytest.fixture
def jax_backend():
    """Set the reference's ingest backend for one test, restored after."""
    before = ingest_backend()
    yield set_ingest_backend
    set_ingest_backend("auto" if before in ("xla", "pallas") else before)


@pytest.mark.parametrize("n_pools", [1, 3, 4, 7, 8])
def test_vertex_pool_matches_jax(n_pools):
    g = np.random.default_rng(n_pools)
    v = np.concatenate([g.integers(-(2**31), 2**31, 4000, dtype=np.int64),
                        [-1, 0, 1, 2**31 - 1, -(2**31), 2654435761 % 2**31]]).astype(np.int32)
    want = np.asarray(jschemes.vertex_pool(jnp.asarray(v), n_pools))
    np.testing.assert_array_equal(schemes.vertex_pool(T(v), n_pools).numpy(), want)


def _random_state(r, seed, n_vertices):
    """A state with empty, open and closed estimators, including f2 that
    shares either endpoint of f1 and ids at and past ``n_vertices``."""
    g = np.random.default_rng(seed)
    f1 = g.integers(-1, n_vertices + 3, (r, 2)).astype(np.int32)
    f1[g.random(r) < 0.1] = -1
    shared = np.where(g.random(r) < 0.5, f1[:, 0], f1[:, 1])
    other = g.integers(0, n_vertices + 3, r).astype(np.int32)
    f2 = np.sort(np.stack([shared, other], 1), axis=1).astype(np.int32)
    f2[g.random(r) < 0.2] = -1
    chi = g.integers(0, 40, r).astype(np.int32)
    has_f3 = g.random(r) < 0.6
    return f1, chi, f2, has_f3, np.int64(12345)


@pytest.mark.parametrize("n_pools", [1, 4])
@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_attribution_matches_jax_on_random_states(n_pools, backend, jax_backend):
    f1, chi, f2, has_f3, m = _random_state(256, n_pools, 50)
    jax_backend(backend)
    js = jschemes.LocalScheme(n_vertices=50, n_pools=n_pools)
    jst = type(jax_init_state(1))(*(jnp.asarray(a) for a in (f1, chi, f2, has_f3, m)))
    want = np.asarray(js.estimate(jst))
    st = EstimatorState(*(torch.as_tensor(a) for a in (f1, chi, f2, has_f3, m)))
    ps = schemes.LocalScheme(n_vertices=50, n_pools=n_pools)
    for be in ("kernel", "fused"):  # the segment_sum wrapper (plain on the CPU) and index_add_
        got = ps.estimate(st, backend=be).numpy()
        np.testing.assert_array_equal(got, want)
    assert want.sum() > 0


@pytest.mark.parametrize("n_pools", [1, 4])
@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_local_estimate_matches_jax_from_a_stream(n_pools, backend, jax_backend):
    """The same stream through the JAX engine (local scheme on the xla or
    Pallas-interpret backend, whose estimate runs the segment_sum kernel)
    and the port's: per-vertex estimates bit-identical."""
    jax_backend(backend)
    edges = _edges(1)
    jeng = _jax(4, "local", _local(n_pools))
    jeng.ingest_stream(batches(edges, S))
    peng = _port(4, "local", _local(n_pools), ingest="kernel")
    peng.ingest_stream(batches(edges, S))
    want = np.asarray(jeng.estimate())
    got = peng.estimate()
    assert got.shape == want.shape == (1, NV) and got.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(peng.estimate_tenant(0), np.asarray(jeng.estimate_tenant(0)))
    assert state_sha256(peng.snapshot()) == state_sha256(jeng.snapshot())


def test_local_estimate_launches_nothing_on_the_cpu():
    before = dict(LAUNCHES)
    eng = _port(4, "local", _local(4), ingest="kernel")
    eng.ingest_stream(batches(_edges(), S))
    assert eng.estimate().sum() > 0
    assert LAUNCHES == before


@pytest.mark.parametrize("n_valid", [64, 37, 0])
def test_naive_update_matches_jax(n_valid):
    g = np.random.default_rng(n_valid)
    W = g.integers(0, 40, (S, 2)).astype(np.int32)
    W = W[W[:, 0] != W[:, 1]][:S]
    W = np.concatenate([W, np.zeros((S - len(W), 2), np.int32)])
    r = 300
    jst = jax_init_state(r)
    st = init_state(r)
    for step in range(3):  # three batches, so later ones meet non-empty state
        key = jax.random.fold_in(jax.random.PRNGKey(9), step)
        jst = jschemes.naive_parallel_update(jst, jnp.asarray(W), n_valid, key)
        st = schemes.naive_parallel_update(st, T(W), n_valid, rng.fold_in(rng.PRNGKey(9), step))
    for f in jst._fields:
        np.testing.assert_array_equal(getattr(st, f).numpy(), np.asarray(getattr(jst, f)), err_msg=f)
    assert int(st.m_seen) == 3 * n_valid


@pytest.mark.parametrize("scheme,params", [("global", None), ("naive", None),
                                           ("local", _local(4))])
@pytest.mark.parametrize("K", [1, 4])
def test_engine_matches_jax_under_each_scheme(scheme, params, K):
    edges = _edges(2)[:600] if scheme == "naive" else _edges(2)
    jeng, peng = _jax(K, scheme, params), _port(K, scheme, params)
    jeng.ingest_stream(batches(edges, S))
    peng.ingest_stream(batches(edges, S))
    assert peng.step == jeng.step
    assert state_sha256(peng.snapshot()) == state_sha256(jeng.snapshot())
    np.testing.assert_array_equal(peng.estimate(), np.asarray(jeng.estimate()))
    assert str(peng.snapshot()["scheme"]) == str(jeng.snapshot()["scheme"]) == scheme


@pytest.mark.parametrize("K", [1, 4])
def test_local_snapshots_cross_restore(K):
    stream = list(batches(_edges(3), S))
    params = _local(4)
    # JAX -> port
    jeng = _jax(K, "local", params)
    jeng.ingest_stream(iter(stream[:5]))
    peng = TriangleCountEngine.from_snapshot(from_jax_snapshot(jeng.snapshot()), chunk_size=K,
                                             scheme_params=params, device="cpu")
    assert peng.scheme.name == "local"
    jeng.ingest_stream(iter(stream[5:]))
    peng.ingest_stream(iter(stream[5:]))
    assert state_sha256(peng.snapshot()) == state_sha256(jeng.snapshot())
    np.testing.assert_array_equal(peng.estimate(), np.asarray(jeng.estimate()))
    # port -> JAX
    peng2 = _port(K, "local", params)
    peng2.ingest_stream(iter(stream[:6]))
    jeng2 = _jax(K, "local", params)
    jeng2.restore(to_jax_snapshot(peng2.snapshot()))
    peng2.ingest_stream(iter(stream[6:]))
    jeng2.ingest_stream(iter(stream[6:]))
    np.testing.assert_array_equal(peng2.estimate(), np.asarray(jeng2.estimate()))


def test_snapshot_mismatch_across_schemes():
    local = _port(1, "local", _local(4))
    local.ingest(*next(batches(_edges(), S)))
    snap = local.snapshot()
    with pytest.raises(SnapshotMismatch, match="scheme 'local'.*runs 'global'"):
        _port().restore(snap)
    with pytest.raises(SnapshotMismatch, match="scheme 'global'"):
        _port(1, "naive").restore(_port().snapshot())
    jsnap = _jax(1, "local", _local(4)).snapshot()
    with pytest.raises(SnapshotMismatch):
        _port(1, "naive").restore(from_jax_snapshot(jsnap))
    no_key = _port().snapshot()
    del no_key["scheme"]  # a snapshot from before schemes: global
    _port().restore(no_key)
    with pytest.raises(SnapshotMismatch):
        _port(1, "local", _local(4)).restore(no_key)


def test_scheme_registry_errors_match_jax():
    for name, params in (("nope", None), ("local", None), ("local", {"n_vertices": 10, "x": 1})):
        with pytest.raises(ValueError) as ours:
            schemes.resolve_scheme(name, params)
        with pytest.raises(ValueError) as ref:
            jschemes.resolve_scheme(name, params)
        assert str(ours.value) == str(ref.value)
    assert sorted(schemes.SCHEMES) == sorted(jschemes.SCHEMES)
    for r, params in ((64, {"n_vertices": 0}), (64, {"n_vertices": 5, "n_pools": 3}),
                      (64, {"n_vertices": 5, "n_pools": 0})):
        with pytest.raises(ValueError) as ours:
            EngineConfig(r=r, batch_size=8, scheme="local", scheme_params=params, device="cpu")
        with pytest.raises(ValueError) as ref:
            jschemes.resolve_scheme("local", params).validate(r)
        assert str(ours.value) == str(ref.value)
    cfg = EngineConfig(r=64, batch_size=8, scheme="local",
                       scheme_params={"n_vertices": 9, "n_pools": 2}, device="cpu")
    assert cfg.scheme_params == (("n_pools", 2), ("n_vertices", 9))


def test_unported_scheme_stages_name_their_roadmap_item():
    """The distributed stages that ROADMAP A.13 named are ported: each
    scheme's axis roles, update kind and shardable flag are the reference's,
    and the base scheme, which has no query, raises the reference's text."""
    for ours, ref in ((schemes.GlobalScheme(), jschemes.GlobalScheme()),
                      (schemes.NaiveScheme(), jschemes.NaiveScheme()),
                      (schemes.LocalScheme(n_vertices=4), jschemes.LocalScheme(n_vertices=4))):
        assert tuple(ours.axis_roles()) == tuple(ref.axis_roles())
        assert ours.axis_roles()._fields == ref.axis_roles()._fields
        assert (ours.update_kind, ours.shardable_estimate) == (
            ref.update_kind, ref.shardable_estimate)
    for call, jcall in ((lambda s: s.partial_estimate(None, offset=0, r=4),
                         lambda s: s.partial_estimate(None, offset=0, r=4)),
                        (lambda s: s.combine_estimates(None, r=4),
                         lambda s: s.combine_estimates(None, r=4))):
        with pytest.raises(NotImplementedError) as got:
            call(schemes.EstimatorScheme())
        with pytest.raises(NotImplementedError) as want:
            jcall(jschemes.EstimatorScheme())
        assert str(got.value) == str(want.value)


def test_local_triangle_counts_match_jax():
    edges = erdos_renyi_stream(80, 900, seed=3)
    for n in (80, 40):
        np.testing.assert_array_equal(local_triangle_counts(edges, n), jax_local_counts(edges, n))


def test_cli_local_line_matches_jax_cli():
    args = ["--scheme", "local", "--pools", "4", "--graph", "er", "--nodes", "100",
            "--edges", "1500", "--estimators", "4096", "--batch", "256", "--chunk", "4"]
    env = {"PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin"}

    def line(module, extra):
        out = subprocess.run([sys.executable, "-m", module, *args, *extra], cwd=ROOT, env=env,
                             capture_output=True, text=True, timeout=300, check=True).stdout
        return next(ln for ln in out.splitlines() if ln.startswith("local[tenant 0] "))

    jax_line = line("repro.launch.stream", ["--ckpt-every", "0"])
    assert line("repro_torch.launch.stream", ["--device", "cpu"]) == jax_line
    assert "l1.err=" in jax_line and "top5=[" in jax_line
