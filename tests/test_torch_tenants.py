"""Banks of tenants in the port against the JAX reference's vmapped bank.

Every engine comparison runs the port and ``repro.engine.TriangleCountEngine``
with the same ``n_tenants`` and seeds on the CPU at a small size (r = 512, s =
32, T = 2 or 3) and holds them equal by sha256 of every state field: per-tenant
and broadcast streams, per-batch and chunked ingest with every form of the
chunk's counts, the three schemes, turnstile deletions, the per-tenant
queries and counters, snapshots and checkpoint directories carried across
packages, window and decay over a bank (one ring per tenant), and the
CLI's ``--tenants`` lines. The plain version of each
kernel's bank form is held to T calls of its one-tenant form; on a CUDA
machine the kernels' bank forms are held to T one-tenant launches, bit for
bit, with the same launches per call.
"""
import hashlib
import io
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest

import repro  # noqa: F401  -- enables x64
import torch

from repro.engine import EngineConfig as JaxConfig
from repro.engine import TriangleCountEngine as JaxEngine
from repro.engine import run_stream as jax_run_stream
from repro.launch import stream as jax_cli
from repro.launch import stream_serve as jax_serve_cli
from repro_torch import rng
from repro_torch.core import bulk, schemes
from repro_torch.core.rank import rank_all_chunk
from repro_torch.core.state import init_state, tenant_state
from repro_torch.data import graph_stream as tgs
from repro_torch.engine import EngineConfig, SnapshotMismatch, TriangleCountEngine, run_stream
from repro_torch.interop import (
    estimate_sha256,
    from_jax_snapshot,
    state_sha256,
    tenant_snapshot,
    to_jax_snapshot,
    window_sha256,
)
from repro_torch.kernels import CUDA_LAUNCHES
from repro_torch.kernels.bitonic import bitonic_sort_tiles, bitonic_sort_tiles_plain
from repro_torch.kernels.fused_ingest import fused_ingest, fused_ingest_plain
from repro_torch.kernels.multisearch import multisearch_counts, multisearch_counts_plain
from repro_torch.kernels.segment_sum import segment_sum, segment_sum_plain
from repro_torch.kernels.segscan import segmented_max_scan, segscan, segscan_plain
from repro_torch.launch import stream as cli
from repro_torch.launch import stream_serve as serve_cli

R, S = 512, 32
LOCAL = {"n_vertices": 700, "n_pools": 4}
FIELDS = ("f1", "chi", "f2", "has_f3", "m_seen")
T_ = torch.from_numpy


def _stream(seed, cut=0):
    edges, _ = tgs.planted_triangle_stream(40, 300, 700, seed=seed)
    return edges[: len(edges) - cut]  # 420 edges: 13 batches of 32 and a ragged one


def _bank_batches(streams):
    """(W (T, s, 2), n_valid (T,)) items, one batch of each tenant's stream
    per item; a tenant whose stream has ended gets an empty batch."""
    per = [list(tgs.batches(e, S)) for e in streams]
    for i in range(max(len(p) for p in per)):
        W = np.zeros((len(per), S, 2), np.int32)
        nv = np.zeros((len(per),), np.int64)
        for t, p in enumerate(per):
            if i < len(p):
                W[t], nv[t] = p[i]
        yield W, nv


def _items(kind, T):
    """The test streams: one broadcast to every tenant, or one per tenant,
    cut to different lengths so that the ragged tails' counts differ."""
    if kind == "broadcast":
        return list(tgs.batches(_stream(1), S))
    return list(_bank_batches([_stream(10 + t, cut=7 * t) for t in range(T)]))


def _cfg(T, scheme="global", K=1, seeds=None, **dynamic):
    return dict(r=R, batch_size=S, n_tenants=T, chunk_size=K, scheme=scheme,
                seeds=seeds or tuple(3 + t for t in range(T)),
                scheme_params=LOCAL if scheme == "local" else None, **dynamic)


def _port(T, scheme="global", K=1, **kw):
    return TriangleCountEngine(EngineConfig(device="cpu", **_cfg(T, scheme, K, **kw)))


def _jax(T, scheme="global", K=1, **kw):
    return JaxEngine(JaxConfig(**_cfg(T, scheme, K, **kw)))


def _field_digests(snap) -> dict:
    s = from_jax_snapshot(snap)
    return {f: hashlib.sha256(np.ascontiguousarray(s[f]).tobytes()).hexdigest()
            for f in FIELDS + ("root_keys",)}


def _assert_same(port, ref, msg=""):
    """Equal state (every field's sha256 and the whole state's), cursors,
    counters and estimates."""
    ps, rs = port.snapshot(), ref.snapshot()
    assert _field_digests(ps) == _field_digests(rs), msg
    assert state_sha256(ps) == state_sha256(rs), msg
    assert (port.step, port.dyn_step) == (ref.step, ref.dyn_step), msg
    for k in ("batches_ingested", "edges_ingested", "delete_batches", "edges_deleted"):
        assert getattr(port.diag, k) == getattr(ref.diag, k), (msg, k)
    pe, re_ = port.estimate(), np.asarray(ref.estimate())
    assert pe.shape == re_.shape and estimate_sha256(pe) == estimate_sha256(re_), msg


# ---------------------------------------------------------------------------
# engines side by side
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("scheme,K,kind,T", [
    ("global", 1, "broadcast", 2), ("global", 4, "per_tenant", 3),
    ("global", 2, "broadcast", 3), ("global", 1, "per_tenant", 2),
    ("local", 1, "per_tenant", 2), ("local", 4, "broadcast", 3),
    ("naive", 1, "per_tenant", 2),
])
def test_bank_matches_jax(scheme, K, kind, T):
    """``ingest_stream`` over a bank (chunks where K > 1, the ragged tail
    batch by batch) equals the JAX engine's vmapped bank."""
    items = _items(kind, T)
    port, ref = _port(T, scheme, K), _jax(T, scheme, K)
    assert port.ingest_stream(iter(items)) == ref.ingest_stream(iter(items)) == len(items)
    _assert_same(port, ref, f"{scheme} K={K} {kind}")
    assert port.estimate().shape == ((T, LOCAL["n_vertices"]) if scheme == "local" else (T,))


@pytest.mark.parametrize("form", ["scalar", "per_batch", "per_tenant"])
def test_chunk_counts_forms_match_jax(form):
    """``ingest_chunk`` with a scalar, (K,) or (T, K) ``n_valids``, on a
    broadcast and on a per-tenant superbatch."""
    T, K = 2, 4
    nvs = {"scalar": 20, "per_batch": np.array([32, 5, 0, 17]),
           "per_tenant": np.array([[32, 5, 0, 17], [9, 32, 32, 1]])}[form]
    items = _items("per_tenant", T)
    Ws_t = np.stack([W for W, _ in items[:K]], axis=1)  # (T, K, s, 2)
    Ws_b = np.stack([W for W, _ in tgs.batches(_stream(1), S)][:K])  # (K, s, 2)
    port, ref = _port(T, K=K), _jax(T, K=K)
    for Ws in (Ws_b, Ws_t):
        staged = port.stage_chunk(Ws, nvs)
        assert staged.Wb.shape == (T, K, S, 2) and staged.nv.shape == (T, K)
        port.ingest_chunk(staged)
        ref.ingest_chunk(Ws, nvs)
    _assert_same(port, ref, form)
    want = np.broadcast_to(np.asarray(nvs), (T, K)).max(axis=0).sum() * 2
    assert port.diag.edges_ingested == want


@pytest.mark.parametrize("scheme", ["global", "local"])
def test_deletions_match_jax(scheme):
    """Broadcast and per-tenant deletion batches after per-tenant inserts,
    then a signed stream over the bank through ``ingest_signed_stream``."""
    T = 2
    items = _items("per_tenant", T)
    port, ref = _port(T, scheme, K=2), _jax(T, scheme, K=2)
    for eng in (port, ref):
        eng.ingest_stream(iter(items[:6]))
        # every tenant deletes the same 9 edges: tenant 0's first ones
        eng.delete(items[0][0][0][:9])
        # each tenant deletes edges of its own stream, a different count each
        D = np.stack([items[1][0][t] for t in range(T)])
        eng.delete(D, np.array([13, 4]))
    _assert_same(port, ref, f"{scheme} after deletions")
    assert port.diag.edges_deleted == 9 + 13 and port.diag.delete_batches == 2
    signed = [(W, nv, 1) for W, nv in items[6:10]]
    signed.insert(2, (np.stack([items[7][0][t] for t in range(T)])[:, :5], np.array([5, 5]), -1))
    for eng in (port, ref):
        assert eng.ingest_signed_stream(iter(signed)) == len(signed)
    _assert_same(port, ref, f"{scheme} after the signed stream")


def test_estimate_tenants_and_counters_match_jax():
    T = 3
    items = _items("per_tenant", T)
    port, ref = _port(T, K=4), _jax(T, K=4)
    for eng in (port, ref):
        eng.ingest_stream(iter(items))
    np.testing.assert_array_equal(port.estimate_tenants([2, 0]),
                                  np.asarray(ref.estimate_tenants([2, 0])))
    for t in range(T):
        assert port.estimate_tenant(t) == ref.estimate_tenant(t)
    np.testing.assert_array_equal(port.edges_seen(), ref.edges_seen())
    assert port.edges_seen().tolist() == [420, 413, 406]
    # the max over tenants of each batch, as the reference counts
    assert port.diag.edges_ingested == ref.diag.edges_ingested == 420
    assert port.diag.batches_ingested == ref.diag.batches_ingested == len(items)


def test_bank_equals_one_tenant_engines():
    """T = 3 tenants on distinct streams equal three one-tenant engines with
    seeds t on stream t (the reference's ``test_bank_matches_independent_runs
    _bitforbit``), on the chunked route and its ragged tail."""
    T = 3
    streams = [_stream(20 + t, cut=5 * t) for t in range(T)]
    bank = _port(T, K=4, seeds=(0, 1, 2))
    bank.ingest_stream(_bank_batches(streams))
    snap = bank.snapshot()
    ests = bank.estimate()
    for t in range(T):
        one = _port(1, K=4, seeds=(t,))
        one.ingest_stream(tgs.batches(streams[t], S))
        alone = one.snapshot()
        for f in FIELDS:
            np.testing.assert_array_equal(snap[f][t], alone[f][0], err_msg=f"tenant {t} {f}")
        assert state_sha256(tenant_snapshot(snap, t)) == state_sha256(alone)
        assert ests[t] == one.estimate()[0]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_snapshot_cross_restores_and_continues(writer):
    """A T = 2 snapshot taken mid-stream by either engine restores into the
    other, and both then go on bit-identically."""
    T = 2
    items = _items("per_tenant", T)
    src = _jax(T, K=4) if writer == "jax" else _port(T, K=4)
    src.ingest_stream(iter(items[:5]))
    snap = src.snapshot()
    if writer == "jax":
        dst = TriangleCountEngine.from_snapshot(from_jax_snapshot(snap), chunk_size=4,
                                                device="cpu")
    else:
        dst = _jax(T, K=4)
        dst.restore(to_jax_snapshot(snap))
    assert dst.config.n_tenants == T
    for eng in (src, dst):
        eng.ingest_stream(iter(items[5:]))
    port, ref = (dst, src) if writer == "jax" else (src, dst)
    assert state_sha256(port.snapshot()) == state_sha256(ref.snapshot())
    np.testing.assert_array_equal(port.estimate(), np.asarray(ref.estimate()))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_dir_cross_restores(writer, tmp_path):
    """A T = 2 run cut after 6 batches and resumed from its checkpoint
    directory by the other package ends in the state of one uninterrupted
    run."""
    T = 2
    items = _items("per_tenant", T)
    straight = _port(T, K=4)
    run_stream(straight, iter(items))
    ck = str(tmp_path / "ck")
    if writer == "jax":
        jax_run_stream(_jax(T, K=4), iter(items[:6]), ckpt_dir=ck, ckpt_every=2)
        resumed = _port(T, K=4)
        rep = run_stream(resumed, iter(items), ckpt_dir=ck, ckpt_every=2)
    else:
        run_stream(_port(T, K=4), iter(items[:6]), ckpt_dir=ck, ckpt_every=2)
        resumed = _jax(T, K=4)
        rep = jax_run_stream(resumed, iter(items), ckpt_dir=ck, ckpt_every=2)
    assert rep.resumed_from == 6 and rep.batches == len(items) - 6
    assert state_sha256(resumed.snapshot()) == state_sha256(straight.snapshot())


# ---------------------------------------------------------------------------
# window and decay over a bank: one ring per tenant
# ---------------------------------------------------------------------------
def _assert_same_windowed(port, ref, msg=""):
    """_assert_same, plus the rings (window_sha256) and the expiry count."""
    _assert_same(port, ref, msg)
    assert window_sha256(port.snapshot()) == window_sha256(ref.snapshot()), msg
    assert port.diag.window_expired == ref.diag.window_expired > 0, msg


@pytest.mark.parametrize("mode,T,K,kind", [
    ({"window": 48}, 2, 1, "per_tenant"), ({"window": 48}, 3, 4, "per_tenant"),
    ({"window": 100}, 3, 1, "broadcast"), ({"decay": 20.0}, 2, 4, "broadcast"),
    ({"decay": 20.0}, 3, 1, "per_tenant"), ({"decay": 30.0}, 2, 1, "per_tenant"),
])
def test_windowed_bank_matches_jax(mode, T, K, kind):
    """Window and decay over a bank: per-tenant rings, expiry batches that
    take every tenant's next <= s expired rows a round, decay TTLs from each
    tenant's own seed; state, rings and counters equal to the JAX engine's
    after every batch (per-batch) or at the end (chunked)."""
    items = _items(kind, T)
    port, ref = _port(T, K=K, **mode), _jax(T, K=K, **mode)
    if K == 1:
        for i, (W, nv) in enumerate(items):
            port.ingest(W, nv)
            ref.ingest(W, nv)
            assert window_sha256(port.snapshot()) == window_sha256(ref.snapshot()), i
    else:
        assert port.ingest_stream(iter(items)) == ref.ingest_stream(iter(items))
    _assert_same_windowed(port, ref, f"{mode} T={T} K={K} {kind}")
    lens = port.snapshot()["window_len"]
    if "window" in mode:
        assert (lens == mode["window"]).all()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_windowed_bank_midwindow_snapshot_restores_into_either_package(writer):
    """The reference's mid-window round trip (window 48, two tenants,
    ``tests/test_dynamic.py``), the snapshot restored into the other package
    too: every run ends in the uninterrupted run's state and rings."""
    T, items = 2, list(tgs.batches(tgs.erdos_renyi_stream(30, 200, seed=31), S))
    half = len(items) // 2
    mk = {"port": lambda: _port(T, window=48), "jax": lambda: _jax(T, window=48)}
    src = mk[writer]()
    for W, nv in items[:half]:
        src.ingest(W, nv)
    snap = src.snapshot()
    assert {"window_edges", "window_expiry", "window_len", "dyn_step"} <= set(snap)
    assert np.asarray(snap["window_edges"]).shape == (T, 48, 2)
    ends = []
    for reader in ("port", "jax"):
        dst = mk[reader]()
        dst.restore(from_jax_snapshot(snap) if reader == "port" else to_jax_snapshot(snap))
        assert dst.dyn_step == half
        for W, nv in items[half:]:
            dst.ingest(W, nv)
        ends.append(dst)
    for W, nv in items[half:]:
        src.ingest(W, nv)
    for dst in ends:
        assert state_sha256(dst.snapshot()) == state_sha256(src.snapshot())
        assert window_sha256(dst.snapshot()) == window_sha256(src.snapshot())
    _assert_same_windowed(*ends, f"restored from {writer}")


@pytest.mark.parametrize("mode,K", [({"window": 64}, 1), ({"window": 64}, 2),
                                    ({"decay": 25.0}, 2)])
def test_windowed_bank_explicit_deletions_match_jax(mode, K):
    """Explicit deletions on a windowed bank through ``ingest_signed_stream``:
    each tenant's deleted edges leave its ring (``_forget_window``), so the
    clock never deletes them twice."""
    T = 2
    items = _items("per_tenant", T)
    signed = [(W, nv, 1) for W, nv in items]
    # tenant t deletes rows of its own batch 3 still in its window, then
    # both delete an edge of batch 1 that may have expired already for one
    D = np.stack([items[3][0][t][:6] for t in range(T)])
    signed.insert(5, (D, np.array([6, 4]), -1))
    signed.insert(9, (np.stack([items[8][0][t][:3] for t in range(T)]), np.array([3, 3]), -1))
    port, ref = _port(T, K=K, **mode), _jax(T, K=K, **mode)
    for eng in (port, ref):
        assert eng.ingest_signed_stream(iter(signed)) == len(signed)
    _assert_same_windowed(port, ref, f"{mode} K={K}")
    assert port.diag.edges_deleted == 9 and port.diag.delete_batches == 2


def test_tenant_count_mismatch_raises():
    items = _items("broadcast", 2)
    port, ref = _port(2), _jax(2)
    for eng in (port, ref):
        eng.ingest(*items[0])
    for snap in (port.snapshot(), from_jax_snapshot(ref.snapshot())):
        for T in (1, 3):
            with pytest.raises(SnapshotMismatch, match="n_tenants"):
                _port(T).restore(snap)
    with pytest.raises(ValueError, match="3 tenant batches for 2 tenants"):
        port.ingest(np.zeros((3, S, 2), np.int32))
    # a windowed bank: both packages' snapshots restore into the port's
    # engine of the same tenant count, with equal rings, and into no other
    port, ref = _port(2, window=64), _jax(2, window=64)
    for eng in (port, ref):
        eng.ingest_stream(iter(items[:3]))
    for snap in (port.snapshot(), from_jax_snapshot(ref.snapshot())):
        same = _port(2, window=64)
        same.restore(snap)
        assert window_sha256(same.snapshot()) == window_sha256(ref.snapshot())
        for T in (1, 3):
            with pytest.raises(SnapshotMismatch, match="n_tenants"):
                _port(T, window=64).restore(snap)


def _lines(main, argv, monkeypatch=None) -> list:
    buf = io.StringIO()
    with redirect_stdout(buf):
        if monkeypatch is None:
            main(argv)
        else:
            monkeypatch.setattr(sys, "argv", ["stream", *argv])
            main()
    return [ln for ln in buf.getvalue().splitlines() if not ln.startswith("processed ")]


@pytest.mark.parametrize("extra", [["--chunk", "4"], ["--scheme", "local", "--pools", "4"]])
def test_cli_tenant_lines_match_jax_cli(extra, monkeypatch):
    args = ["--graph", "planted", "--triangles", "60", "--edges", "600", "--nodes", "1200",
            "--estimators", "1024", "--batch", "64", "--seed", "2", "--tenants", "3", *extra]
    port = _lines(cli.main, [*args, "--device", "cpu"])
    ref = _lines(jax_cli.main, [*args, "--ckpt-every", "0"], monkeypatch)
    assert port == ref
    heads = [ln.split(" ", 1)[0] for ln in port[1:]]
    if "local" in extra:
        assert heads == ["local[tenant"] * 3
    else:
        assert [ln.split(":")[0] for ln in port[1:]] == [
            "estimate", "estimate[tenant 1]", "estimate[tenant 2]"]


def test_cli_refuses_a_windowed_bank(monkeypatch):
    """A windowed bank, which the port's CLI once refused, prints the JAX
    CLI's lines for the same flags."""
    args = ["--graph", "er", "--nodes", "20", "--edges", "40", "--estimators", "64",
            "--batch", "8", "--tenants", "2", "--window", "10"]
    port = _lines(cli.main, [*args, "--device", "cpu"])
    assert port == _lines(jax_cli.main, [*args, "--ckpt-every", "0"], monkeypatch)
    assert port[1].startswith("dynamic: ") and port[-1].startswith("estimate[tenant 1]: ")


@pytest.mark.parametrize("main,ref,extra", [
    ("stream", "stream", ["--tenants", "3", "--window", "150", "--chunk", "4"]),
    ("stream_serve", "stream_serve", ["--window", "600", "--report-every", "4"]),
    ("stream", "stream", ["--tenants", "2", "--decay", "40", "--chunk", "2"]),
])
def test_cli_windowed_bank_lines_match_jax_cli(main, ref, extra, monkeypatch):
    """``stream --tenants 3 --window 150 --chunk 4``, ``stream_serve
    --window 600`` at its default ``--tenants 2`` and a decayed bank print
    the JAX CLIs' lines."""
    args = ["--graph", "planted", "--triangles", "40", "--edges", "700", "--nodes", "900",
            "--estimators", "512", "--batch", "64", "--seed", "3", *extra]
    mains = {"stream": (cli.main, jax_cli.main), "stream_serve": (serve_cli.main,
                                                                  jax_serve_cli.main)}
    port = _lines(mains[main][0], [*args, "--device", "cpu"])
    want = _lines(mains[ref][1], [*args, "--ckpt-every", "0"] if ref == "stream" else args,
                  monkeypatch)
    timed = ("served ",)  # the serving CLI's wall-clock line
    assert [ln for ln in port if not ln.startswith(timed)] == [
        ln for ln in want if not ln.startswith(timed)]
    assert any(ln.startswith("stream: m=") and "live=" in ln for ln in port)


# ---------------------------------------------------------------------------
# the kernels' bank forms: plain versions on the CPU
# ---------------------------------------------------------------------------
def _bank_chunk(T, K, s, seed):
    g = np.random.default_rng(seed)
    Ws = g.integers(0, 3 * s // 2, size=(T, K, s, 2)).astype(np.int32)
    Ws[:, 0, 0] = [1, 1]  # a self-loop
    Ws[:, -1, 1] = Ws[:, -1, 0]  # a duplicate edge in one batch
    nv = g.integers(0, s + 1, size=(T, K)).astype(np.int32)
    nv[0, 0] = s
    return T_(Ws), T_(nv)


def _warm_bank(T, r, seed):
    """A bank mid-stream: each tenant ran its own chunk from its own key."""
    Ws, nv = _bank_chunk(T, 3, 24, seed)
    keys = torch.stack([rng.PRNGKey(seed + t) for t in range(T)])
    return bulk.bulk_update_chunk(init_state(r, n_tenants=T), Ws, nv, keys, 0, backend="scan")


def _tenants(bank, T):
    return [tenant_state(bank, t) for t in range(T)]


def _assert_states(got, want, msg=""):
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), (msg, f)


@pytest.mark.parametrize("T,K,s", [(2, 1, 16), (3, 4, 24), (2, 2, 40)])
def test_fused_ingest_plain_bank_is_per_tenant(T, K, s):
    """``fused_ingest_plain`` over a bank, with per-tenant first steps
    ((T,) step0), equals T one-tenant calls, and both equal the scan."""
    r = 300
    bank = _warm_bank(T, r, 11)
    Ws, nv = _bank_chunk(T, K, s, 12)
    keys = torch.stack([rng.PRNGKey(100 + t) for t in range(T)])
    step0 = torch.tensor([3 + 5 * t for t in range(T)], dtype=torch.int64)
    structs = bulk.chunk_structures(Ws, nv, use_kernels=False)
    st = (bank.f1, bank.chi, bank.f2, bank.has_f3)
    got = fused_ingest_plain(*st, *structs, Ws, nv, bank.m_seen, keys, step0)
    assert got[0].shape == (T, r, 2)
    for t, one in enumerate(_tenants(bank, T)):
        ones = bulk.chunk_structures(Ws[t], nv[t], use_kernels=False)
        want = fused_ingest_plain(one.f1, one.chi, one.f2, one.has_f3, *ones, Ws[t], nv[t],
                                  one.m_seen, keys[t], int(step0[t]))
        for a, b in zip(got, want):
            assert torch.equal(a[t], b)
    scan = bulk.bulk_update_chunk(bank, Ws, nv, keys, step0, backend="scan")
    fused = bulk.bulk_update_chunk(bank, Ws, nv, keys, step0, backend="fused")
    _assert_states(fused, scan)
    for a, f in zip(got, ("f1", "chi", "f2", "has_f3")):
        assert torch.equal(a, getattr(scan, f))


@pytest.mark.parametrize("T,K,s", [(2, 1, 16), (3, 4, 24)])
def test_rank_all_chunk_bank_folds_tenants_into_tiles(T, K, s):
    """A bank's T·K batches build, on the plain and the kernel route (their
    plain versions here), the structures of T per-tenant builds; the tile
    sort and the scans take the T·K tiles and segments in one call."""
    Ws, nv = _bank_chunk(T, K, s, 5)
    for use_kernels in (False, True):
        got = rank_all_chunk(Ws, nv, use_kernels=use_kernels)
        for t in range(T):
            want = rank_all_chunk(Ws[t], nv[t], use_kernels=use_kernels)
            for f in ("key_desc", "key_rank", "src", "dst", "pos", "rank", "ekey", "epos"):
                assert torch.equal(getattr(got, f)[t], getattr(want, f)), (use_kernels, t, f)
    g = np.random.default_rng(6)
    tile = 64
    keys = T_(g.integers(-4, 50, T * K * tile).astype(np.int64))
    vals = T_(np.arange(T * K * tile, dtype=np.int32))
    ks, vs = bitonic_sort_tiles(keys, vals, tile)
    for t in range(T):
        lo, hi = t * K * tile, (t + 1) * K * tile
        wk, wv = bitonic_sort_tiles_plain(keys[lo:hi], vals[lo:hi], tile)
        assert torch.equal(ks[lo:hi], wk) and torch.equal(vs[lo:hi], wv)
    flags = T_(g.random(T * K * tile) < 0.1)
    flags[:: K * tile] = True  # every tenant's first segment opens at its start
    for scan in (segscan, segmented_max_scan):
        whole = scan(vals, flags)
        for t in range(T):
            lo, hi = t * K * tile, (t + 1) * K * tile
            assert torch.equal(whole[lo:hi], scan(vals[lo:hi], flags[lo:hi]))
    assert torch.equal(segscan(vals, flags), segscan_plain(vals, flags))


@pytest.mark.parametrize("n,q", [(1, 5), (37, 100), (256, 700)])
def test_multisearch_plain_bank_is_per_row(n, q):
    """Rows of sorted keys (a tenant each), row-strided views too, searched
    row by row equal B one-row searches."""
    g = np.random.default_rng(n)
    B = 3
    keys = np.sort(g.integers(-3, 2 * n, size=(B, n)), axis=1).astype(np.int64)
    keys[1, n // 2:] = np.iinfo(np.int64).max  # a padded row, as the deletion path pads
    qs = g.integers(-5, 2 * n + 3, size=(B, q)).astype(np.int64)
    wide = torch.zeros((B, 2, n), dtype=torch.int64)
    wide[:, 1] = T_(keys)
    for k in (T_(keys), wide[:, 1]):  # dense, and a row-strided view
        lt, le = multisearch_counts(k, T_(qs))
        assert lt.shape == le.shape == (B, q) and lt.dtype == torch.int32
        for b in range(B):
            wlt, wle = multisearch_counts_plain(T_(keys[b]), T_(qs[b]))
            assert torch.equal(lt[b], wlt) and torch.equal(le[b], wle)


def test_segment_sum_plain_bank_drops_ids_within_their_tenant():
    """A bank's scatter equals T one-tenant scatters; an id past a tenant's
    bins is dropped, never added to the next tenant's first bins."""
    g = np.random.default_rng(3)
    T, n, m, d = 3, 200, 17, 2
    vals = T_(g.integers(-9, 10, (T, n, d)).astype(np.float64))
    ids = T_(g.integers(-3, m + 6, (T, n)).astype(np.int32))
    got = segment_sum(vals, ids, m)
    assert got.shape == (T, m, d)
    for t in range(T):
        assert torch.equal(got[t], segment_sum_plain(vals[t], ids[t], m))
    spill = torch.full((2, 4), m, dtype=torch.int32)  # ids m .. : the next tenant's bin 0
    out = segment_sum_plain(torch.ones((2, 4, 1), dtype=torch.float64), spill, m)
    assert out.sum() == 0


def test_per_batch_bank_is_per_tenant():
    """``bulk_update_all`` and ``bulk_delete_update`` over a bank (per-tenant
    counts) equal T one-tenant calls."""
    T, r = 3, 300
    bank = _warm_bank(T, r, 21)
    Ws, nv = _bank_chunk(T, 1, 40, 22)
    W, nv = Ws[:, 0], nv[:, 0]
    keys = torch.stack([rng.PRNGKey(7 * t) for t in range(T)])
    got = bulk.bulk_update_all(bank, W, nv, keys)
    dels = bulk.bulk_delete_update(got, W.flip(-1), nv // 2)
    ones = _tenants(bank, T)
    for t in range(T):
        want = bulk.bulk_update_all(ones[t], W[t], int(nv[t]), keys[t])
        _assert_states(tenant_state(got, t), want, t)
        _assert_states(tenant_state(dels, t),
                       bulk.bulk_delete_update(want, W[t].flip(-1), int(nv[t]) // 2), t)
    local = schemes.LocalScheme(n_vertices=70, n_pools=3)
    est = local.estimate(got)
    for t in range(T):
        assert torch.equal(est[t], local.estimate(tenant_state(got, t)))


# ---------------------------------------------------------------------------
# the kernels' bank forms on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's CUDA kernels)")
    return torch.device("cuda", 0)


def _launches(name, fn):
    CUDA_LAUNCHES[name] = 0
    out = fn()
    torch.cuda.synchronize()
    return out, CUDA_LAUNCHES[name]


@pytest.mark.cuda
@pytest.mark.parametrize("T,K,s,r", [(2, 1, 16, 300), (4, 4, 1500, 5000)])
def test_cuda_bank_kernels_equal_one_tenant_calls(cuda, T, K, s, r):
    """Each kernel's bank form equals T one-tenant calls bit for bit, with
    the launches of one one-tenant call."""
    bank = _warm_bank(T, r, 31)
    bank = type(bank)(*(x.to(cuda) for x in bank))
    Ws, nv = (x.to(cuda) for x in _bank_chunk(T, K, s, 32))
    keys = torch.stack([rng.PRNGKey(40 + t) for t in range(T)]).to(cuda)
    step0 = torch.tensor([2 + t for t in range(T)], dtype=torch.int64, device=cuda)
    structs = bulk.chunk_structures(Ws, nv, use_kernels=True)
    st = (bank.f1, bank.chi, bank.f2, bank.has_f3)
    got, n_bank = _launches("fused_ingest", lambda: fused_ingest(
        *st, *structs, Ws, nv, bank.m_seen, keys, step0))
    want = fused_ingest_plain(*st, *structs, Ws, nv, bank.m_seen, keys, step0)
    for t, one in enumerate(_tenants(bank, T)):
        ones = bulk.chunk_structures(Ws[t], nv[t], use_kernels=True)
        alone, n_one = _launches("fused_ingest", lambda one=one, ones=ones, t=t: fused_ingest(
            one.f1, one.chi, one.f2, one.has_f3, *ones, Ws[t], nv[t], one.m_seen, keys[t],
            int(step0[t])))
        assert n_bank == n_one == K
        for a, b, c in zip(got, alone, want):
            assert torch.equal(a[t], b) and torch.equal(a, c)
    # multisearch: rows of a bank, dense and row-strided
    q = bulk._delete_queries(bank)
    dk = bulk.delete_keys(Ws[:, 0], nv[:, 0])
    (lt, le), n_bank = _launches("multisearch_counts", lambda: multisearch_counts(dk, q))
    for t in range(T):
        (a, b), n_one = _launches("multisearch_counts",
                                  lambda t=t: multisearch_counts(dk[t].contiguous(), q[t]))
        assert n_bank == n_one == 1
        assert torch.equal(lt[t], a) and torch.equal(le[t], b)
    wide = bulk.delete_keys(Ws, nv)  # (T, K, s): row t's keys of batch 0, strided
    lt2, le2 = multisearch_counts(wide[:, 0], q)
    assert torch.equal(lt2, lt) and torch.equal(le2, le)
    # segment_sum: the local scheme's attribution over the bank
    local = schemes.LocalScheme(n_vertices=700, n_pools=4)
    vals, ids = local.attribution_inputs(bank, 0, r)
    out, n_bank = _launches("segment_sum", lambda: segment_sum(vals, ids, 700))
    assert torch.equal(out, segment_sum_plain(vals, ids, 700))
    for t in range(T):
        alone, n_one = _launches("segment_sum", lambda t=t: segment_sum(vals[t], ids[t], 700))
        assert n_bank == n_one == 1 and torch.equal(out[t], alone)
    # the bank's chunk on the kernel route equals the plain route
    k = bulk.bulk_update_chunk(bank, Ws, nv, keys, step0, backend="kernel")
    p = bulk.bulk_update_chunk(bank, Ws, nv, keys, step0, backend="fused")
    _assert_states(k, p)
