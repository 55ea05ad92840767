"""The port's engine, service loop, data path and CLI against the JAX
reference: snapshots in the same format that cross-restore in both
directions and continue bit-identically, the same generated streams and
superbatches, chunked ingest equal to per-batch ingest, and the package's
import hygiene (no jax, no repro)."""
import ast
import functools
import pathlib

import numpy as np
import pytest

import repro  # noqa: F401  -- enables x64
import jax
import jax.numpy as jnp
import torch

from repro.core import bulk as jax_bulk
from repro.core.state import init_state as jax_init_state
from repro.data import graph_stream as jgs
from repro.data import prefetch as jpf
from repro.engine import EngineConfig as JaxConfig
from repro.engine import TriangleCountEngine as JaxEngine
from repro_torch.data import graph_stream as tgs
from repro_torch.data import prefetch as tpf
from repro_torch.engine import EngineConfig, TriangleCountEngine, run_stream
from repro_torch.interop import from_jax_snapshot, state_sha256, to_jax_snapshot, window_sha256
from repro_torch.launch import stream as cli

ROOT = pathlib.Path(__file__).resolve().parents[1]
STATE = ("f1", "chi", "f2", "has_f3", "m_seen")


def _edges(seed=0):
    edges, _ = tgs.planted_triangle_stream(40, 700, 900, seed=seed)
    return edges  # 820 edges


def _port(r=512, s=64, K=1, **kw):
    return TriangleCountEngine(EngineConfig(r=r, batch_size=s, chunk_size=K, seeds=(5,),
                                            device="cpu", **kw))


def _jax(r=512, s=64, K=1):
    return JaxEngine(JaxConfig(r=r, batch_size=s, chunk_size=K, seeds=(5,)))


def _assert_snap_equal(a, b):
    for k in STATE + ("root_keys", "step", "dyn_step", "config"):
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


def test_snapshot_format_matches_jax_engine():
    snaps = []
    for eng in (_port(), _jax()):
        for W, nv in tgs.batches(_edges()[:130], 64):
            eng.ingest(W, nv)
        snaps.append(eng.snapshot())
    port, ref = snaps
    assert set(port) == set(ref)
    for k in ref:
        a, b = np.asarray(port[k]), np.asarray(ref[k])
        assert (a.shape, a.dtype) == (b.shape, b.dtype), k
    _assert_snap_equal(port, ref)
    assert str(port["scheme"]) == str(ref["scheme"]) == "global"


@pytest.mark.parametrize("K", [1, 4])
def test_jax_snapshot_continues_in_port(K):
    batches = list(tgs.batches(_edges(1), 64))  # 13 batches, ragged tail
    jeng = _jax(K=K)
    jeng.ingest_stream(iter(batches[:5]))
    peng = TriangleCountEngine.from_snapshot(from_jax_snapshot(jeng.snapshot()),
                                             chunk_size=K, device="cpu")
    jeng.ingest_stream(iter(batches[5:]))
    peng.ingest_stream(iter(batches[5:]))
    _assert_snap_equal(jeng.snapshot(), peng.snapshot())
    np.testing.assert_allclose(peng.estimate(), jeng.estimate(), rtol=1e-12)


@pytest.mark.parametrize("K", [1, 4])
def test_port_snapshot_continues_in_jax(K):
    batches = list(tgs.batches(_edges(2), 64))
    peng = _port(K=K)
    peng.ingest_stream(iter(batches[:6]))
    jeng = _jax(K=K)
    jeng.restore(to_jax_snapshot(peng.snapshot()))
    peng.ingest_stream(iter(batches[6:]))
    jeng.ingest_stream(iter(batches[6:]))
    _assert_snap_equal(jeng.snapshot(), peng.snapshot())


def test_chunked_run_stream_equals_per_batch_and_restore():
    edges = _edges(3)
    per_batch, chunked = _port(K=1), _port(K=4)
    rep1 = run_stream(per_batch, tgs.batches(edges, 64))
    rep4 = run_stream(chunked, tgs.batches(edges, 64))
    assert (rep1.batches, rep1.edges) == (rep4.batches, rep4.edges) == (13, 820)
    assert state_sha256(per_batch.snapshot()) == state_sha256(chunked.snapshot())
    resumed = _port(K=4, ingest="kernel")
    resumed.restore(per_batch.snapshot())
    _assert_snap_equal(resumed.snapshot(), chunked.snapshot())


# the lone-batch route: on the kernel ingest backend the single plan ingests a
# lone batch as a one-batch chunk (on CPU tensors fused_ingest's plain version)
LONE_R, LONE_S, LONE_SEEDS = 256, 32, (5, 6, 7)
LONE_CASES = {  # name -> (batch after which m_seen jumps by 2^32, per-batch (T,) counts)
    "full_ragged_empty": (None, ((32, 19, 0), (19, 0, 32), (0, 32, 19), (32, 32, 32))),
    "fresh_empty_first": (None, ((0, 0, 0), (32, 7, 0), (5, 32, 32))),
    "past_2^32": (0, ((32, 32, 32), (32, 19, 0), (19, 0, 32))),
}
_jax_bank_update = jax.jit(jax.vmap(jax_bulk.bulk_update_all))


def _lone_batch(b):
    """Batch b of each of three tenants, (3, s, 2), real edges past every count."""
    E = _edges(4).astype(np.int32)
    return np.stack([E[(3 * b + t) * LONE_S:(3 * b + t + 1) * LONE_S] for t in range(3)])


@functools.lru_cache(maxsize=None)
def _lone_reference(case):
    """The JAX scan of bulk_update_all over a bank of three tenants: each
    batch's state as numpy arrays (before that batch's m_seen jump)."""
    jump, counts = LONE_CASES[case]
    st = jax.tree.map(lambda x: jnp.stack([x] * 3), jax_init_state(LONE_R))
    roots = jnp.stack([jax.random.PRNGKey(seed) for seed in LONE_SEEDS])
    out = []
    for b, nv in enumerate(counts):
        keys = jax.vmap(jax.random.fold_in, in_axes=(0, None))(roots, b)
        st = _jax_bank_update(st, jnp.asarray(_lone_batch(b)), jnp.asarray(nv, jnp.int32), keys)
        out.append(tuple(np.asarray(x) for x in st))
        if b == jump:
            st = st._replace(m_seen=st.m_seen + 2**32)
    return out


def _run_lone(case, T, K=1, **kw):
    """Ingest the case batch by batch into a fresh engine of T tenants,
    holding the state to the reference's tenants [0, T) after every batch."""
    jump, counts = LONE_CASES[case]
    eng = TriangleCountEngine(EngineConfig(r=LONE_R, batch_size=LONE_S, n_tenants=T,
                                           chunk_size=K, seeds=LONE_SEEDS[:T], device="cpu",
                                           **kw))
    for b, (nv, want) in enumerate(zip(counts, _lone_reference(case), strict=True)):
        eng.ingest(_lone_batch(b)[:T], np.array(nv[:T]))
        for f, got, ref in zip(STATE, eng.state, want):
            np.testing.assert_array_equal(got.numpy(), ref[:T], err_msg=f"{f} batch {b}")
        if b == jump:
            eng._state = eng._state._replace(m_seen=eng._state.m_seen + 2**32)
    assert eng.step == eng.diag.batches_ingested == len(counts)
    return eng


@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("T", [1, 3])
@pytest.mark.parametrize("case", sorted(LONE_CASES))
def test_lone_batch_as_chunk_matches_reference(case, T, K):
    """Full, ragged and empty batches, a fresh state whose first batch is
    empty and a stream length past 2^32, one tenant and a bank with
    per-tenant counts, whatever the chunk size: bit for bit the reference's
    per-batch update, every batch through the one-batch chunk route."""
    eng = _run_lone(case, T, K, ingest="kernel")
    assert eng.batches_as_chunk == len(LONE_CASES[case][1])


@pytest.mark.parametrize("scheme", ["global", "local"])
@pytest.mark.parametrize("ingest", ["fused", "scan", "kernel"])
def test_lone_batch_route_by_backend(ingest, scheme):
    """The CPU backends keep the per-batch route (the counter stays 0), for
    the local scheme too; on the kernel backend the local scheme's base
    chunk update gives the per-batch state as well."""
    kw = {"scheme_params": {"n_vertices": 900, "n_pools": 4}} if scheme == "local" else {}
    eng = _run_lone("full_ragged_empty", 3, ingest=ingest, scheme=scheme, **kw)
    assert eng.batches_as_chunk == (4 if ingest == "kernel" else 0)


def test_estimate_cache_and_reports():
    eng = _port(K=4)
    seen = []
    run_stream(eng, tgs.batches(_edges(), 64), report_every=4,
               on_report=lambda step, est, m: seen.append((step, float(est[0]), int(m[0]))))
    assert [s for s, _, _ in seen] == [4, 8, 12]
    first = eng.estimate()
    assert eng.estimate() is first  # answered from the per-step cache
    eng.ingest(*next(tgs.batches(_edges(), 64)))
    assert eng.estimate() is not first


def test_restore_rejects_other_shapes_and_schemes():
    snap = _port().snapshot()
    with pytest.raises(ValueError):
        _port(r=256).restore(snap)
    snap["scheme"] = np.array("local")
    with pytest.raises(ValueError, match="scheme"):
        _port().restore(snap)


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TriangleCountEngine(EngineConfig(r=64, batch_size=8))
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--graph", "er", "--nodes", "20", "--edges", "30", "--estimators", "64",
                  "--batch", "8"])


def test_unported_features_name_their_roadmap_item():
    # a window (or decay) over more than one tenant, once refused, runs as
    # the reference's does: equal state and rings on a small stream
    W = np.stack([jgs.erdos_renyi_stream(20, 8, seed=t) for t in range(2)]).astype(np.int32)
    for mode in ({"window": 10}, {"decay": 10.0}):
        cfg = dict(r=64, batch_size=8, n_tenants=2, seeds=(1, 2), **mode)
        port = TriangleCountEngine(EngineConfig(device="cpu", **cfg))
        ref = JaxEngine(JaxConfig(**cfg))
        for _ in range(3):
            port.ingest(W)
            ref.ingest(W)
        assert port.diag.window_expired == ref.diag.window_expired > 0, mode
        assert state_sha256(port.snapshot()) == state_sha256(ref.snapshot()), mode
        assert window_sha256(port.snapshot()) == window_sha256(ref.snapshot()), mode
    # schemes are ported: an unknown name raises the reference's ValueError
    with pytest.raises(ValueError, match=r"unknown scheme 'nope'; registered: "
                                         r"\['global', 'local', 'naive'\]"):
        EngineConfig(r=64, batch_size=8, device="cpu", scheme="nope")


def test_generators_match_jax():
    np.testing.assert_array_equal(jgs.erdos_renyi_stream(60, 200, seed=4),
                                  tgs.erdos_renyi_stream(60, 200, seed=4))
    np.testing.assert_array_equal(jgs.barabasi_albert_stream(300, 4, seed=4),
                                  tgs.barabasi_albert_stream(300, 4, seed=4))
    (je, jt), (te, tt) = (jgs.planted_triangle_stream(20, 300, 500, seed=4),
                          tgs.planted_triangle_stream(20, 300, 500, seed=4))
    np.testing.assert_array_equal(je, te)
    assert jt == tt == 20
    for (jw, jn), (tw, tn) in zip(jgs.batches(te, 64), tgs.batches(te, 64), strict=True):
        np.testing.assert_array_equal(jw, tw)
        assert jn == tn


def test_superbatches_match_jax():
    batches = list(tgs.batches(_edges(), 64))
    for (jk, jp), (tk, tp) in zip(jpf.superbatches(iter(batches), 4, 64),
                                  tpf.superbatches(iter(batches), 4, 64), strict=True):
        assert jk == tk
        for a, b in zip(jp, tp):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_prefetch_reraises_producer_error():
    def source():
        yield 1
        yield 2
        raise KeyError("bad tail")

    q = tpf.PrefetchQueue(source(), depth=1)
    assert [q.get(), q.get()] == [(1, False), (2, False)]
    with pytest.raises(KeyError, match="bad tail"):
        q.get()
    assert list(tpf.PrefetchQueue(iter(range(5)), depth=2)) == [(i, False) for i in range(5)]


def test_cli_prints_the_output_contract(capsys):
    cli.main(["--device", "cpu", "--graph", "planted", "--triangles", "30", "--edges", "400",
              "--nodes", "600", "--estimators", "1024", "--batch", "64", "--chunk", "2",
              "--assert-rel-err", "0.9"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "stream: m=490 tau=30"
    assert out[1].startswith("processed 490 edges in ")
    assert out[2].startswith("estimate: ") and "rel.err" in out[2]
    assert out[3].startswith("rel.err ") and out[3].endswith("OK")


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tools" / "torch_rates.py", ROOT / "tools" / "serve_ab.py"]
    assert len(files) > 20
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{f.relative_to(ROOT)} imports {mod}"
