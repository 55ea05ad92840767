"""The port's dynamic streams against the JAX reference: turnstile deletions,
count-based sliding windows and exponential decay.

Everything runs on the CPU at small sizes on seeded numpy inputs, and every
comparison is exact: the deletion path draws no randomness, so states,
snapshot arrays (the window ring included) and estimates are bit-identical
to the reference's for every scheme and mode, through snapshot
cross-restores and checkpointed resumes in both directions. Windowed chunked
runs flush expiry once a chunk in both packages, so they are held to the
reference at the same K. Also here: the repairs of a scalar ``n_valids`` in
``stage_chunk``/``ingest_chunk`` and of the CLI's default ``--ckpt-dir``.
"""
import io
import os
import shutil
import subprocess
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest

import repro  # noqa: F401  -- enables x64
import jax
import jax.numpy as jnp
import torch

from repro.core import bulk as jbulk
from repro.core.state import init_state as jax_init_state
from repro.data import graph_stream as jgs
from repro.engine import EngineConfig as JaxConfig
from repro.engine import SnapshotMismatch as JaxMismatch
from repro.engine import TriangleCountEngine as JaxEngine
from repro.engine import run_signed_stream as jax_run_signed_stream
from repro.engine.faults import validate_signed_item as jax_validate
from repro.launch import stream as jax_cli
from repro.primitives.search import set_multisearch_backend
from repro_torch.core import bulk, schemes
from repro_torch.core.state import EstimatorState
from repro_torch.data import graph_stream as tgs
from repro_torch.engine import (
    EngineConfig,
    SnapshotMismatch,
    TriangleCountEngine,
    run_signed_stream,
    validate_signed_item,
)
from repro_torch.interop import from_jax_snapshot, state_sha256, to_jax_snapshot
from repro_torch.launch import stream as cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = torch.from_numpy
FIELDS = EstimatorState._fields
R, S = 512, 32
LOCAL = {"n_vertices": 700, "n_pools": 4}
jax_delete = jax.jit(jbulk.bulk_delete_update)
jax_delete_chunk = jax.jit(jbulk.bulk_delete_chunk)


def _edges(seed=0):
    edges, _ = tgs.planted_triangle_stream(40, 300, 700, seed=seed)
    return edges  # 420 edges: 13 full batches of 32 and a ragged one of 4


def _signed_all_insert(edges):
    return np.concatenate([edges, np.ones((len(edges), 1), np.int32)], axis=1)


def _cfg(scheme="global", K=1, **kw):
    params = LOCAL if scheme == "local" else None
    return dict(r=R, batch_size=S, chunk_size=K, seeds=(5,), scheme=scheme,
                scheme_params=params, **kw)


def _port(scheme="global", K=1, **kw):
    return TriangleCountEngine(EngineConfig(device="cpu", **_cfg(scheme, K, **kw)))


def _jax(scheme="global", K=1, **kw):
    return JaxEngine(JaxConfig(**_cfg(scheme, K, **kw)))


def _assert_snap_equal(a, b, msg=""):
    """Two snapshots hold the same engine: every key and array, the window
    ring included."""
    a, b = from_jax_snapshot(a), from_jax_snapshot(b)
    assert set(a) == set(b), msg
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=f"{msg} {k}")


def _assert_engines_equal(port, ref, msg="", counters=True):
    """Equal snapshots, cursors and estimates and, for two engines that ran
    the same stream from the start, equal dynamic counters."""
    _assert_snap_equal(port.snapshot(), ref.snapshot(), msg)
    assert port.step == ref.step and port.dyn_step == ref.dyn_step, msg
    for k in ("delete_batches", "edges_deleted", "window_expired") if counters else ():
        assert getattr(port.diag, k) == getattr(ref.diag, k), (msg, k)
    np.testing.assert_array_equal(port.estimate(), np.asarray(ref.estimate()), err_msg=msg)


# ---------------------------------------------------------------------------
# core: bulk_delete_update and bulk_delete_chunk
# ---------------------------------------------------------------------------
def _warm_state(r, seed):
    """A mid-stream JAX state over few vertices: f1 and f2 set on many
    estimators, closed wedges, and unset slots (an earlier deletion of two
    edges reset the estimators that sampled them)."""
    g = np.random.default_rng(seed)
    Ws = g.integers(0, 24, size=(3, 16, 2)).astype(np.int32)
    Ws[Ws[:, :, 0] == Ws[:, :, 1], 1] += 1  # no self-loops
    js = jbulk._bulk_update_chunk_scan(jax_init_state(r), jnp.asarray(Ws),
                                       jnp.asarray([16, 16, 9], jnp.int32),
                                       jax.random.PRNGKey(seed), 0)
    return jax_delete(js, jnp.asarray(Ws[0, :2]), jnp.int32(2))


def _closing_edges(js):
    f1, f2 = np.asarray(js.f1), np.asarray(js.f2)
    u, v, a, b = f1[:, 0], f1[:, 1], f2[:, 0], f2[:, 1]
    o1 = np.where((u == a) | (u == b), v, u)
    o2 = np.where((a == u) | (a == v), b, a)
    return np.stack([o1, o2], 1)[(u >= 0) & (a >= 0)]


def _deletion_batch(js, kind, n_valid, s, seed):
    """s rows of which the first ``n_valid`` are edges the state holds as
    f1 (``kind`` "f1"), as f2, as a wedge's closing edge, or a mix of those
    and edges it does not hold; each row given in either orientation."""
    g = np.random.default_rng(seed)
    f1, f2 = np.asarray(js.f1), np.asarray(js.f2)
    pools = {"f1": f1[f1[:, 0] >= 0], "f2": f2[f2[:, 0] >= 0], "closing": _closing_edges(js)}
    if kind == "mixed":
        pool = np.concatenate([*pools.values(), g.integers(0, 30, (40, 2))])
    else:
        pool = pools[kind]
    keys = np.unique(np.sort(pool, 1), axis=0)  # one copy per edge key
    keys = keys[keys[:, 0] != keys[:, 1]]
    rows = keys[g.permutation(len(keys))[:n_valid]]
    flip = g.random(len(rows)) < 0.5
    rows[flip] = rows[flip][:, ::-1]
    D = g.integers(0, 30, (s, 2)).astype(np.int32)  # padding rows hold junk
    D[: len(rows)] = rows
    return D, len(rows)


def _state_from_jax(js) -> EstimatorState:
    return EstimatorState(*(T(np.array(getattr(js, f))) for f in FIELDS))


def _assert_same(js, ts, msg=""):
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(js, f)), getattr(ts, f).numpy(),
                                      err_msg=f"{msg} {f}")


@pytest.mark.parametrize("search", ["eager", "kernel"])
@pytest.mark.parametrize("kind,n_valid", [
    ("f1", 1), ("f1", 24), ("f2", 24), ("closing", 24), ("mixed", 0), ("mixed", 24),
])
def test_bulk_delete_update_matches_jax(search, kind, n_valid):
    r, s = 300, 24
    js = _warm_state(r, 3)
    assert (np.asarray(js.f2)[:, 0] >= 0).any() and np.asarray(js.has_f3).any()
    assert (np.asarray(js.f1)[:, 0] < 0).any()  # unset slots query negative keys
    D, nv = _deletion_batch(js, kind, n_valid, s, seed=n_valid)
    assert nv == min(n_valid, s)
    want = jax_delete(js, jnp.asarray(D), jnp.int32(nv))
    got = bulk.bulk_delete_update(_state_from_jax(js), T(D), nv, search)
    _assert_same(want, got, f"{kind} n_valid={nv}")
    if nv:  # the batch really cleared something
        assert not np.array_equal(np.asarray(want.has_f3), np.asarray(js.has_f3)) or \
            not np.array_equal(np.asarray(want.f1), np.asarray(js.f1))


@pytest.mark.parametrize("backend", ["scan", "fused", "kernel"])
def test_bulk_delete_chunk_matches_jax(backend):
    """K = 3 batches (s, 0 and 5 valid rows): the JAX chunk (hoisted sorts,
    lt-trimmed test), K JAX single batches and the port on every backend."""
    r, s = 300, 24
    js = _warm_state(r, 4)
    Ds = np.stack([_deletion_batch(js, k, n, s, seed=i)[0]
                   for i, (k, n) in enumerate((("mixed", s), ("f1", s), ("closing", 5)))])
    nv = np.array([s, 0, 5], np.int32)
    want = jax_delete_chunk(js, jnp.asarray(Ds), jnp.asarray(nv))
    seq = js
    for D, n in zip(Ds, nv):
        seq = jax_delete(seq, jnp.asarray(D), jnp.int32(n))
    _assert_same(want, _state_from_jax(seq), "jax chunk vs batches")
    for search in ("eager", "kernel"):
        got = schemes.GlobalScheme().delete_chunk_update(
            _state_from_jax(js), T(Ds), T(nv), backend=backend, search=search)
        _assert_same(want, got, f"{backend}/{search}")


def test_bulk_delete_update_matches_pallas_interpret():
    """The reference's Pallas counting kernel (interpret mode on the CPU)
    gives the same state as the port's kernel route: a tiny case."""
    r, s = 40, 8
    js = _warm_state(r, 5)
    D, nv = _deletion_batch(js, "mixed", 6, s, seed=9)
    set_multisearch_backend("pallas")
    try:
        want = jbulk.bulk_delete_update(js, jnp.asarray(D), jnp.int32(nv))
    finally:
        set_multisearch_backend("auto")
    _assert_same(want, bulk.bulk_delete_update(_state_from_jax(js), T(D), nv, "kernel"))


def test_schemes_expire_is_delete_update():
    js = _warm_state(200, 6)
    D, nv = _deletion_batch(js, "mixed", 16, 16, seed=1)
    for sch in (schemes.GlobalScheme(), schemes.NaiveScheme(),
                schemes.LocalScheme(n_vertices=30, n_pools=2)):
        a = sch.expire(_state_from_jax(js), T(D), nv)
        b = sch.delete_update(_state_from_jax(js), T(D), nv, search="kernel")
        _assert_same(jax_delete(js, jnp.asarray(D), jnp.int32(nv)), a, sch.name)
        for f in FIELDS:
            assert torch.equal(getattr(a, f), getattr(b, f))


# ---------------------------------------------------------------------------
# data: the signed-stream helpers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stream_helpers_match_jax(seed):
    edges = _edges(seed)
    churn = tgs.churn_stream(edges, 0.3, seed=seed + 1)
    np.testing.assert_array_equal(churn, jgs.churn_stream(edges, 0.3, seed=seed + 1))
    win = tgs.windowed_stream(edges, 150 + seed)
    np.testing.assert_array_equal(win, jgs.windowed_stream(edges, 150 + seed))
    for stream in (churn, win):
        for a, b in zip(tgs.signed_batches(stream, S), jgs.signed_batches(stream, S),
                        strict=True):
            np.testing.assert_array_equal(a[0], b[0])
            assert a[1:] == b[1:]
        np.testing.assert_array_equal(tgs.live_edges(stream), jgs.live_edges(stream))
    for kw in ({"window": 200}, {"decay": 90.0 + seed}, {}):
        np.testing.assert_array_equal(tgs.dynamic_live_edges(churn, seed=seed, **kw),
                                      jgs.dynamic_live_edges(churn, seed=seed, **kw))
    for decay in (1.5, 48.0, 1e4 + seed):
        assert tgs.decay_cap(decay) == jgs.decay_cap(decay)
        np.testing.assert_array_equal(tgs.decay_ttls(seed, 2**40 - 7, 500, decay),
                                      jgs.decay_ttls(seed, 2**40 - 7, 500, decay))
    for item in ((edges[:4], 4, -1), (edges[:4], 4, 0), (edges[:4], 4), (edges[:4],),
                 (edges[:4], 4, "x"), 7):
        assert validate_signed_item(item) == jax_validate(item)


# ---------------------------------------------------------------------------
# engines side by side
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("scheme,K", [("global", 1), ("global", 3), ("naive", 1),
                                      ("local", 1), ("local", 3)])
def test_all_insert_signed_stream_is_the_insertion_path(scheme, K):
    edges = _edges(1)[:200]
    plain, signed, ref = _port(scheme, K), _port(scheme, K), _jax(scheme, K)
    plain.ingest_stream(tgs.batches(edges, S))
    signed.ingest_signed_stream(tgs.signed_batches(_signed_all_insert(edges), S))
    ref.ingest_signed_stream(jgs.signed_batches(_signed_all_insert(edges), S))
    assert signed.dyn_step == plain.step == ref.dyn_step
    _assert_snap_equal(plain.snapshot(), signed.snapshot(), "signed vs plain")
    _assert_engines_equal(signed, ref, f"{scheme} K={K}")


@pytest.mark.parametrize("scheme,K", [("global", 1), ("global", 3), ("local", 1)])
def test_churn_matches_jax(scheme, K):
    stream = tgs.churn_stream(_edges(2), 0.2, seed=3)
    port, ref = _port(scheme, K), _jax(scheme, K)
    n = port.ingest_signed_stream(tgs.signed_batches(stream, S))
    assert n == ref.ingest_signed_stream(jgs.signed_batches(stream, S))
    assert port.diag.delete_batches > 0 and port.dyn_step > port.step
    _assert_engines_equal(port, ref, f"churn {scheme} K={K}")


@pytest.mark.parametrize("mode", [
    {"window": 250}, {"window": 250, "K": 3}, {"decay": 400.0},
    {"decay": 400.0, "scheme": "local"}, {"window": 300, "deletions": 0.1},
])
def test_window_and_decay_match_jax(mode):
    mode = dict(mode)
    scheme, K, p = mode.pop("scheme", "global"), mode.pop("K", 1), mode.pop("deletions", 0)
    edges = _edges(3)
    port, ref = _port(scheme, K, **mode), _jax(scheme, K, **mode)
    if p:
        stream = tgs.churn_stream(edges, p, seed=4)
        port.ingest_signed_stream(tgs.signed_batches(stream, S))
        ref.ingest_signed_stream(jgs.signed_batches(stream, S))
    else:
        stream = _signed_all_insert(edges)
        port.ingest_stream(tgs.batches(edges, S))
        ref.ingest_stream(jgs.batches(edges, S))
    assert port.diag.window_expired > 0
    assert int(port.snapshot()["window_len"][0]) == len(
        tgs.dynamic_live_edges(stream, seed=5, **mode))
    if scheme == "global":
        assert float(port.estimate()[0]) > 0  # triangles survive the expiry
    _assert_engines_equal(port, ref, str(mode))


def test_estimate_cache_is_cleared_by_delete():
    """Deletions change the state without moving ``step``: a query after one
    must not be answered from the cache."""
    eng = TriangleCountEngine(EngineConfig(r=4096, batch_size=S, device="cpu"))
    eng.ingest(np.array([[0, 1], [0, 2], [1, 2], [2, 3]], np.int32))
    assert float(eng.estimate()[0]) > 0
    eng.delete(np.array([[1, 2]], np.int32))
    assert float(eng.estimate()[0]) == 0.0
    assert (eng.step, eng.dyn_step, eng.diag.delete_batches, eng.diag.edges_deleted) == (1, 2, 1, 1)


# ---------------------------------------------------------------------------
# snapshots
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("K", [1, 3])
def test_midwindow_snapshot_cross_restores_both_ways(K):
    """port -> JAX -> port in the middle of a windowed stream continues bit
    for bit, equal to an uninterrupted run in either package."""
    items = list(tgs.batches(_edges(4), S))
    full_port, full_ref = _port(K=K, window=200), _jax(K=K, window=200)
    full_port.ingest_stream(iter(items))
    full_ref.ingest_stream(iter(items))
    _assert_engines_equal(full_port, full_ref, "uninterrupted")

    a = _port(K=K, window=200)
    a.ingest_stream(iter(items[:6]))
    snap = a.snapshot()
    assert {"window_edges", "window_expiry", "window_len"} <= set(snap)
    b = _jax(K=K, window=200)
    b.restore(to_jax_snapshot(snap))
    b.ingest_stream(iter(items[6:9]))
    c = _port(K=K, window=200)
    c.restore(from_jax_snapshot(b.snapshot()))
    assert c.dyn_step == 9
    c.ingest_stream(iter(items[9:]))
    _assert_engines_equal(c, full_ref, "port -> jax -> port", counters=False)


def test_windowless_snapshot_into_window_engine_raises():
    plain = _port()
    plain.ingest(np.array([[0, 1]], np.int32), 1)
    with pytest.raises(SnapshotMismatch, match="no window state"):
        _port(window=8).restore(plain.snapshot())
    with pytest.raises(JaxMismatch):
        _jax(window=8).restore(to_jax_snapshot(plain.snapshot()))


def test_window_capacity_mismatch_raises():
    a = _port(window=8)
    a.ingest(np.array([[0, 1]], np.int32), 1)
    for eng, exc in ((_port(window=16), SnapshotMismatch), (_port(decay=4.0), SnapshotMismatch),
                     (_jax(window=16), JaxMismatch)):
        with pytest.raises(exc, match="capacity"):
            eng.restore(a.snapshot())


def test_windowed_snapshot_into_plain_engine_is_legal():
    a = _port(window=8)
    a.ingest(np.array([[0, 1], [1, 2]], np.int32), 2)
    b, ref = _port(), _jax()
    b.restore(a.snapshot())
    ref.restore(to_jax_snapshot(a.snapshot()))
    assert b.step == b.dyn_step == 1
    b.ingest(np.array([[2, 3]], np.int32))  # edges stop expiring
    ref.ingest(np.array([[2, 3]], np.int32))
    _assert_engines_equal(b, ref, "windowed into plain")


# ---------------------------------------------------------------------------
# run_signed_stream: checkpointed resume, directories shared with JAX
# ---------------------------------------------------------------------------
def _signed_items():
    return list(tgs.signed_batches(tgs.churn_stream(_edges(5)[:240], 0.3, seed=6), S))


@pytest.mark.parametrize("writer,reader", [("port", "port"), ("jax", "port"),
                                           ("port", "jax")])
def test_run_signed_stream_resume(writer, reader, tmp_path):
    items = _signed_items()
    mk = {"port": (lambda: _port(window=150), run_signed_stream),
          "jax": (lambda: _jax(window=150), jax_run_signed_stream)}
    ref = _jax(window=150)
    jrep = jax_run_signed_stream(ref, iter(items))
    make, run = mk[writer]
    first = make()
    rep = run(first, iter(items), ckpt_dir=str(tmp_path), ckpt_every=3)
    assert rep.batches == jrep.batches == len(items)
    assert first.dyn_step > first.step
    # a run killed mid-stream: drop the newest checkpoints
    for d in sorted(tmp_path.glob("step_*"))[-2:]:
        shutil.rmtree(d)
    make, run = mk[reader]
    again = make()
    rep2 = run(again, iter(items), ckpt_dir=str(tmp_path), ckpt_every=3)
    assert 0 < rep2.batches < len(items)
    assert rep2.resumed_from + rep2.batches == len(items)
    _assert_engines_equal(again, ref, f"{writer} -> {reader}", counters=False)


def test_run_signed_stream_quarantines_like_jax():
    items = _signed_items()
    bad = list(items)
    bad.insert(3, (items[2][0], items[2][1], 0))  # a sign that is neither +1 nor -1
    bad.insert(7, (np.array([[4, 4]], np.int32), 1, 1))  # a self-loop
    port, ref = _port(), _jax()
    prep = run_signed_stream(port, iter(bad))
    jrep = jax_run_signed_stream(ref, iter(bad))
    assert prep.quarantined_batches == jrep.quarantined_batches == 2
    assert prep.dead_letters.reasons() == jrep.dead_letters.reasons()
    assert [it["position"] for it in prep.dead_letters.items] == [4, 8]
    _assert_engines_equal(port, ref, "quarantine")


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
CLI_ARGS = ["--graph", "planted", "--triangles", "60", "--edges", "600", "--nodes", "1200",
            "--estimators", "4096", "--batch", "64", "--seed", "2"]


def _lines(main, argv, monkeypatch=None) -> list:
    buf = io.StringIO()
    with redirect_stdout(buf):
        if monkeypatch is None:
            main(argv)
        else:
            monkeypatch.setattr(sys, "argv", ["stream", *argv])
            main()
    return [ln for ln in buf.getvalue().splitlines() if not ln.startswith("processed ")]


@pytest.mark.parametrize("extra", [
    ["--deletions", "0.2"], ["--window", "500", "--chunk", "4"],
    ["--scheme", "local", "--pools", "4", "--decay", "400"],
])
def test_cli_dynamic_lines_match_jax_cli(extra, monkeypatch):
    port = _lines(cli.main, [*CLI_ARGS, *extra, "--device", "cpu"])
    ref = _lines(jax_cli.main, [*CLI_ARGS, *extra, "--ckpt-every", "0"], monkeypatch)
    assert port == ref
    assert [ln.split()[0] for ln in port] == [
        "stream:", "dynamic:", "local[tenant" if "local" in extra else "estimate:"]
    assert "tau_live=" in port[0] and "tau_live=0" not in port[0]


# ---------------------------------------------------------------------------
# EngineConfig checks and the two repairs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [{"window": -1}, {"decay": 1.0}, {"decay": 0.5},
                                {"window": 8, "decay": 4.0}])
def test_engine_config_checks_match_jax(kw):
    with pytest.raises(ValueError) as ours:
        EngineConfig(r=64, batch_size=8, device="cpu", **kw)
    with pytest.raises(ValueError) as ref:
        JaxConfig(r=64, batch_size=8, **kw)
    assert str(ours.value) == str(ref.value)


def test_ingest_chunk_broadcasts_a_scalar_n_valids():
    """``ingest_chunk(Ws, 20)`` folds K batches of 20 edges each, as the
    reference's does."""
    K = 4
    Ws = np.stack([W for W, _ in tgs.batches(_edges(6)[: K * S], S)])
    port, ref = _port(K=K), _jax(K=K)
    port.ingest_chunk(Ws, 20)
    ref.ingest_chunk(Ws, 20)
    assert int(port.edges_seen()[0]) == int(ref.edges_seen()[0]) == 80
    assert state_sha256(port.snapshot()) == state_sha256(ref.snapshot())
    staged = _port(K=K).stage_chunk(Ws, np.int64(20))
    assert staged.edges == 80 and staged.nv.tolist() == [[20] * K]  # (T, K), as the reference
    with pytest.raises(ValueError, match="n_valids"):
        _port(K=K).stage_chunk(Ws, [20, 20])


def test_cli_ckpt_every_defaults_the_ckpt_dir(tmp_path, monkeypatch):
    """``--ckpt-every 2`` without ``--ckpt-dir`` checkpoints into
    ``repro_stream_ckpt`` in the temp directory and prints the JAX CLI's
    ``estimate:`` line; a rerun resumes from there and prints it again."""
    args = ["--graph", "er", "--nodes", "60", "--edges", "300", "--estimators", "1024",
            "--batch", "64", "--seed", "3"]
    env = {"PYTHONPATH": os.path.join(ROOT, "src"), "PATH": "/usr/bin:/bin",
           "HOME": str(tmp_path), "TMPDIR": str(tmp_path)}

    def run():
        proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.stream", *args,
                               "--device", "cpu", "--ckpt-every", "2"], cwd=ROOT, env=env,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr
        return proc.stdout.splitlines()

    first, second = run(), run()
    want = next(ln for ln in _lines(jax_cli.main, [*args, "--ckpt-every", "0"], monkeypatch)
                if ln.startswith("estimate:"))
    assert [ln for ln in first if ln.startswith("estimate:")] == [want]
    assert [ln for ln in second if ln.startswith("estimate:")] == [want]
    assert any(ln.startswith("processed 0 edges") for ln in second)
    assert (tmp_path / "repro_stream_ckpt").is_dir()
