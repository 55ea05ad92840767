"""The port's elastic serving tier against the JAX reference.

Each scenario below is one function that drives either package through the
same public API (``ElasticBankEngine``, ``ElasticServeLoop``,
``TriangleCountEngine``): the counterpart of each case of
``tests/test_elastic.py`` and of the reference's sharded-plan script
(``tests/_elastic_driver.py``), and a
``local``-scheme bank. The JAX side runs every scenario once, in a
subprocess (this file run as a script) with 8 host devices and
``jax_cpu_enable_async_dispatch`` off, set before its first dispatch: with
asynchronous CPU dispatch the reference's elastic bank is flaky under load
(ROADMAP C.4). The port side runs here on CPU meshes.

Tolerance: exact. Every tenant's state (sha256 of every field), ``step``,
``root_keys`` and estimate after the scenario's calls equal the JAX
elastic bank's after the same calls and the JAX one-tenant engine's with
that seed; the port's one-tenant engine is held to the same. Tenant
snapshots cross both ways between the packages and between elastic and
fixed engines. Sizes: r = 256, s = 16, ``erdos_renyi_stream(30, 160,
seed=5)``, 10 batches. The reference's zero-XLA-compile asserts become the
port's contract: churn within a capacity builds or loads no kernel library
(``repro_torch.kernels.LIBRARY_EVENTS``) and no tier, and slot operations
keep every field's storage. ``TenantQueues`` and the stdin thread's markers
run the reference's cases on both packages' objects, and the port's queues
a contention test.

``src/repro_torch/golden/serve_small.json`` holds the JAX ``stream_serve``
CLI's lines (fixed-bank rolling queries, and an elastic churn with a
checkpointed snapshot, evict and restore under a fault plan), which
``chip_smoke.py`` phase cli holds the card to. Rewrite it with

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_elastic.py --write
"""
from __future__ import annotations

import io
import json
import os
import queue
import re
import subprocess
import sys
import tempfile
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

from repro_torch import rng  # noqa: E402
from repro_torch.core.distributed import ShardedState  # noqa: E402
from repro_torch.data.graph_stream import batches, erdos_renyi_stream  # noqa: E402
from repro_torch.data.prefetch import TenantQueues  # noqa: E402
from repro_torch.engine import ElasticBankEngine, ElasticServeLoop, install_fault_plan  # noqa: E402
from repro_torch.interop import estimate_sha256, state_sha256  # noqa: E402
from repro_torch.kernels import LIBRARY_EVENTS  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import stream_serve as port_serve  # noqa: E402

R, S = 256, 16
LOCAL = (("n_pools", 4), ("n_vertices", 30))
SHARDED = (("tenants=4", "banked_pjit_independent", 4),
           ("tenants=2,estimators=2", "banked_pjit_coordinated", 2))
GOLDEN = ROOT / "src" / "repro_torch" / "golden" / "serve_small.json"
CLI_COMMON = ["--graph", "er", "--nodes", "40", "--edges", "300", "--estimators", "512",
              "--batch", "32"]
CLI_FIXED = [*CLI_COMMON, "--tenants", "2", "--report-every", "3"]
# the checkpoint directory is appended at run time
CLI_ELASTIC = [*CLI_COMMON, "--elastic", "--capacity", "2", "--sessions", "5", "--chunk", "4",
               "--report-every", "3", "--fault-plan", "engine.ingest_chunk:raise@2",
               "--retry-base", "0.001"]


def _stream():
    return list(batches(erdos_renyi_stream(30, 160, seed=5), S))


# ---------------------------------------------------------------------------
# the two packages behind one set of calls
# ---------------------------------------------------------------------------
class Pkg:
    """The calls a scenario makes, for one package: ``port`` (on the CPU) or
    ``jax`` (the reference)."""

    def __init__(self, name: str):
        self.name = name
        if name == "port":
            import repro_torch.engine as eng

            self.eng, self.kw = eng, {"device": "cpu"}
            self.mesh = lambda spec: tmesh.make_stream_mesh(spec, device="cpu", host_devices=8)
        else:
            import repro.engine as eng
            from repro.launch.mesh import make_stream_mesh

            self.eng, self.kw, self.mesh = eng, {}, make_stream_mesh
        self.Loop, self.Res = self.eng.ElasticServeLoop, self.eng.ResilienceConfig
        self._fixed: dict = {}

    def bank(self, **kw):
        return self.eng.ElasticBankEngine(R, S, **kw, **self.kw)

    def fixed(self, seed, its=(), **kw):
        """A one-tenant ``single`` engine seeded ``seed`` after ``its``. One
        engine per scheme is built and reset for each call by restoring its
        fresh snapshot with the seed's root key (a JAX engine compiles per
        instance; the restore contract makes the two the same engine)."""
        key = kw.get("scheme", "global")
        if key not in self._fixed:
            e = self.eng.TriangleCountEngine(self.eng.EngineConfig(
                r=R, batch_size=S, n_tenants=1, seeds=(0,), backend="single", **kw, **self.kw))
            self._fixed[key] = (e, {k: np.array(v) for k, v in e.snapshot().items()})
        e, fresh = self._fixed[key]
        e.restore({**fresh, "root_keys": np.array([[seed >> 32, seed & 0xFFFFFFFF]], np.uint32)})
        for W, nv in its:
            e.ingest(W, nv)
        return e

    def from_snapshot(self, snap, **kw):
        return self.eng.TriangleCountEngine.from_snapshot(snap, **kw, **self.kw)

    def faults(self, spec):
        self.eng.install_fault_plan(self.eng.parse_fault_plan(spec, seed=0) if spec else None)


def _est(e):
    """An estimate as JSON: the float for a scalar scheme, a sha256 for a
    per-vertex one."""
    return float(e) if np.ndim(e) == 0 else estimate_sha256(np.asarray(e, np.float64))


def _out(snap, est) -> dict:
    return {"sha": state_sha256(snap), "step": int(snap["step"]),
            "root_keys": np.asarray(snap["root_keys"]).astype(np.int64).tolist(),
            "est": _est(est)}


def tenant(bank, tid) -> dict:
    return _out(bank.snapshot_tenant(tid), bank.estimate()[bank.slot_of(tid)])


def solo(eng) -> dict:
    return _out(eng.bank_snapshot(), eng.estimate()[0])


# ---------------------------------------------------------------------------
# scenarios: each returns {"bank": {tid: out}, "fixed": {tid: out}, ...}
# ---------------------------------------------------------------------------
def sc_churn(P, hook=None):
    """``test_compile_once_per_capacity``: churn within capacity 2, one
    doubling to 4, churn in the new tier. ``hook(bank, where)`` runs the
    port's contract checks around the churn windows."""
    its = _stream()
    hook = hook or (lambda bank, where: None)
    bank = P.bank(capacity=2, backend="single")
    tiers = [bank.diag.tier_compiles]
    bank.hot_add("a", seed=1)
    bank.hot_add("b", seed=2)
    bank.ingest({"a": its[0]})
    bank.estimate()
    hook(bank, "churn")
    bank.evict("a")
    bank.hot_add("c", seed=3)
    bank.ingest({"b": its[1], "c": its[0]})
    bank.estimate()
    bank.snapshot_tenant("c")
    hook(bank, "churned")
    tiers.append([bank.diag.tier_compiles, bank.capacity])
    bank.hot_add("d", seed=4)  # the bank is full: capacity doubles
    tiers.append([bank.diag.tier_compiles, bank.diag.grows, bank.capacity])
    bank.hot_add("e", seed=5)
    hook(bank, "churn")
    bank.evict("e")
    bank.hot_add("f", seed=6)
    bank.ingest({"b": its[2], "d": its[0], "f": its[0]})
    bank.estimate()
    hook(bank, "churned")
    tiers.append(bank.diag.tier_compiles)
    return {"bank": {t: tenant(bank, t) for t in "bcdf"},
            "fixed": {"b": solo(P.fixed(2, its[1:3])), "c": solo(P.fixed(3, its[:1])),
                      "d": solo(P.fixed(4, its[:1])), "f": solo(P.fixed(6, its[:1]))},
            "tiers": tiers, "diag": bank.diag.as_dict()}


def sc_hot_add(P, chunk):
    """``test_hot_add_bit_identity_vs_fixed``: tenants joining a churned
    bank see the stream a one-tenant engine sees."""
    its = _stream()
    bank = P.bank(capacity=2, backend="single", chunk_size=chunk)
    bank.hot_add("warm", seed=99)
    bank.ingest({"warm": its[3]})
    bank.evict("warm")
    bank.hot_add("a", seed=7)
    bank.hot_add("b", seed=8)
    if chunk == 1:
        for W, nv in its:
            bank.ingest({"a": (W, nv)})
        for W, nv in its[:4]:
            bank.ingest({"b": (W, nv)})
    else:
        for i in range(0, len(its), chunk):
            bank.ingest_chunk({"a": its[i:i + chunk]})
        bank.ingest_chunk({"b": its[:chunk]})
        bank.ingest_chunk({"b": its[chunk:4]})
    return {"bank": {t: tenant(bank, t) for t in "ab"},
            "fixed": {"a": solo(P.fixed(7, its)), "b": solo(P.fixed(8, its[:4]))}}


def sc_snapshot_restore(P):
    """``test_snapshot_restore_under_concurrent_ingest``."""
    its = _stream()
    bank = P.bank(capacity=2, backend="single")
    bank.hot_add("a", seed=1)
    bank.hot_add("b", seed=2)
    for W, nv in its[:5]:
        bank.ingest({"a": (W, nv), "b": (W, nv)})
    snap = bank.snapshot_tenant("a")
    bank.evict("a")
    for W, nv in its[5:8]:
        bank.ingest({"b": (W, nv)})
    bank.restore_tenant("a", snap)
    restored = _out(bank.snapshot_tenant("a"), 0.0)
    for W, nv in its[5:]:
        bank.ingest({"a": (W, nv)})
    for W, nv in its[8:]:
        bank.ingest({"b": (W, nv)})
    return {"bank": {t: tenant(bank, t) for t in "ab"},
            "fixed": {"a": solo(P.fixed(1, its)), "b": solo(P.fixed(2, its))},
            "at_snapshot": _out(snap, 0.0), "restored": restored}


def sc_crosses_fixed(P):
    """``test_snapshot_crosses_into_fixed_engine``."""
    its = _stream()
    half = len(its) // 2
    bank = P.bank(capacity=2, backend="single")
    bank.hot_add("a", seed=3)
    for W, nv in its[:half]:
        bank.ingest({"a": (W, nv)})
    alone = P.from_snapshot(bank.snapshot_tenant("a"))
    for W, nv in its[half:]:
        alone.ingest(W, nv)
    bank.evict("a")
    bank.restore_tenant("a", alone.bank_snapshot())
    return {"bank": {"a": tenant(bank, "a")}, "fixed": {"a": solo(P.fixed(3, its))}}


def sc_empty_batch(P):
    """``test_empty_batch_is_a_state_noop``: the step advances, the state
    does not move."""
    its = _stream()
    bank = P.bank(capacity=2, backend="single")
    bank.hot_add("a", seed=1)
    bank.ingest({"a": its[0]})
    before = bank.snapshot_tenant("a")
    bank.ingest({"a": (np.zeros((S, 2), np.int32), 0)})
    return {"bank": {"a": tenant(bank, "a")}, "before": _out(before, 0.0),
            "fixed": {"a": solo(P.fixed(1, [its[0], (np.zeros((S, 2), np.int32), 0)]))}}


def sc_evict_isolated(P):
    """``test_eviction_isolated_from_neighbors``."""
    its = _stream()
    bank = P.bank(capacity=2, backend="single")
    bank.hot_add("a", seed=1)
    bank.hot_add("b", seed=2)
    bank.ingest({"a": its[0], "b": its[0]})
    before = _out(bank.snapshot_tenant("b"), 0.0)
    bank.evict("a")
    bank.hot_add("a2", seed=9)
    bank.ingest({"a2": its[1]})
    return {"bank": {t: tenant(bank, t) for t in ("b", "a2")}, "b_before": before,
            "fixed": {"b": solo(P.fixed(2, its[:1])), "a2": solo(P.fixed(9, its[1:2]))}}


def sc_rejects_unbanked(P):
    try:
        P.bank(capacity=2, backend="shardmap")
    except ValueError as e:
        return {"error": str(e)}
    return {"error": None}


def sc_local(P):
    """A ``local``-scheme bank: per-batch and chunked tenants, one grow."""
    its = _stream()
    bank = P.bank(capacity=2, backend="single", chunk_size=2, scheme="local",
                  scheme_params=LOCAL)
    bank.hot_add("a", seed=4)
    for W, nv in its[:3]:
        bank.ingest({"a": (W, nv)})
    bank.hot_add("b", seed=5)
    bank.ingest_chunk({"a": its[3:5], "b": its[:2]})
    bank.hot_add("c", seed=6)  # grows to 4
    bank.ingest({"c": its[0], "b": its[2]})
    loc = {"scheme": "local", "scheme_params": LOCAL}
    return {"bank": {t: tenant(bank, t) for t in "abc"},
            "fixed": {"a": solo(P.fixed(4, its[:5], **loc)), "b": solo(P.fixed(5, its[:3], **loc)),
                      "c": solo(P.fixed(6, its[:1], **loc))}}


def sc_serve_concurrent(P):
    """``test_concurrent_ingest_and_query_bit_exact``: the loop drained
    equals direct ingest."""
    its = _stream()
    bank = P.bank(capacity=2, backend="single", chunk_size=3)
    with P.Loop(bank) as loop:
        loop.add_tenant("a", seed=7).result(30)
        loop.add_tenant("b", seed=8).result(30)
        ok = all([loop.submit("a", W, nv) for W, nv in its]
                 + [loop.submit("b", W, nv) for W, nv in its[:4]])
        first = loop.query("a").result(30)["tenant"]
        drained = loop.drain(30)
        final = loop.query("a").result(30)
    return {"bank": {t: tenant(bank, t) for t in "ab"},
            "fixed": {"a": solo(P.fixed(7, its)), "b": solo(P.fixed(8, its[:4]))},
            "loop": {"submitted": ok, "first": first, "drained": drained,
                     "final": _est(final["estimate"]), "stale_age": final["stale_age"],
                     "queries": loop.stats.queries_answered, "batches": loop.stats.batches}}


def sc_backpressure(P):
    """``test_backpressure_degrades_with_tagged_staleness`` (the consumer
    not started, so the answers are deterministic)."""
    its = _stream()
    bank = P.bank(capacity=2, backend="single")
    loop = P.Loop(bank, resilience=P.Res(backpressure_depth=1))
    bank.hot_add("a", seed=1)
    loop.queues.add_tenant("a")
    bank.ingest({"a": its[0]})
    bank.estimate()  # fills the version-keyed cache
    bank.ingest({"a": its[1]})  # and moves the bank past it
    loop.queues.put("a", its[2])  # backlog 1 >= depth: degrade
    stale = loop._answer_one("a")
    stats = (loop.stats.degraded_queries, loop.stats.max_staleness)
    loop.queues.take("a")
    fresh = loop._answer_one("a")
    return {"stale": {"age": stale["stale_age"], "est": _est(stale["estimate"]),
                      "version": stale["version"]},
            "stats": list(stats),
            "fresh": {"age": fresh["stale_age"], "est": _est(fresh["estimate"])},
            "fixed": {"after_1": solo(P.fixed(1, its[:1])), "after_2": solo(P.fixed(1, its[:2]))}}


def sc_fault_retried(P):
    """``test_ingest_fault_is_retried``."""
    its = _stream()
    P.faults("engine.ingest:raise@1")
    try:
        bank = P.bank(capacity=2, backend="single")
        with P.Loop(bank) as loop:
            loop.add_tenant("a", seed=7).result(30)
            for W, nv in its[:3]:
                loop.submit("a", W, nv)
            loop.drain(30)
    finally:
        P.faults(None)
    return {"bank": {"a": tenant(bank, "a")}, "fixed": {"a": solo(P.fixed(7, its[:3]))},
            "retries": loop.stats.retries}


def sc_evict_pending(P):
    """``test_evict_drops_pending_and_restore_rejoins``."""
    its = _stream()
    bank = P.bank(capacity=2, backend="single")
    loop = P.Loop(bank)
    bank.hot_add("a", seed=1)
    loop.queues.add_tenant("a")
    loop.queues.put("a", its[0])
    loop.queues.put("a", its[1])
    lost = loop.queues.remove_tenant("a")
    return {"lost": lost, "backlog": loop.queues.backlog()}


def sc_sharded(P, spec, backend, cap):
    """The reference's sharded-plan script on one banked plan: churn with
    staggered per-batch and chunked ingest, a grow (which moves slots
    between shards), and tenant a's snapshot at half stream for the
    cross-mesh leg."""
    its = _stream()
    mesh = P.mesh(spec)
    bank = P.bank(capacity=cap, backend=backend, mesh=mesh, chunk_size=3)
    bank.hot_add("w", seed=50)
    bank.ingest({"w": its[7]})
    bank.estimate()
    bank.evict("w")
    bank.hot_add("a", seed=11)
    half = len(its) // 2
    for i, (W, nv) in enumerate(its):
        if i == half:
            x_snapshot = bank.snapshot_tenant("a")
        bank.ingest({"a": (W, nv)})
    bank.hot_add("b", seed=12)
    bank.ingest_chunk({"b": its[:3]})
    bank.ingest_chunk({"b": its[3:4]})
    est = _est(bank.estimate()[bank.slot_of("a")])
    gathered = _est(bank.estimate(gather=True)[bank.slot_of("a")])
    before = {t: tenant(bank, t) for t in "ab"}
    while bank.n_active < bank.capacity:
        bank.hot_add(f"fill{bank.n_active}", seed=60 + bank.n_active)
    bank.hot_add("over", seed=70)  # the free list is empty: capacity doubles
    grown = [bank.capacity, bank.diag.tier_compiles, bank.diag.grows]
    bank.evict("over")
    bank.hot_add("over2", seed=71)
    bank.ingest({"over2": its[0]})
    return {"bank": {t: tenant(bank, t) for t in ("a", "b", "over2")}, "before_grow": before,
            "fixed": {"a": solo(P.fixed(11, its)), "b": solo(P.fixed(12, its[:4])),
                      "over2": solo(P.fixed(71, its[:1]))},
            "est_a": est, "gather_a": gathered, "grown": grown, "plan": bank.backend,
            "x_snapshot": x_snapshot}


def sc_cross_mesh(P, snap):
    """A tenant snapshot taken on one banked plan continues on a one-tenant
    engine and on the other mesh's elastic bank beside a neighbour."""
    its = _stream()
    half = len(its) // 2
    alone = P.from_snapshot(snap)
    for W, nv in its[half:]:
        alone.ingest(W, nv)
    other = P.bank(capacity=2, backend="banked_pjit_coordinated",
                   mesh=P.mesh("tenants=2,estimators=2"))
    other.hot_add("neighbor", seed=90)
    other.restore_tenant("x", snap)
    for W, nv in its[half:]:
        other.ingest({"x": (W, nv), "neighbor": (W, nv)})
    return {"bank": {"x": tenant(other, "x")}, "alone": solo(alone)}


def sc_sharded_serve(P):
    """The serve loop over a sharded bank drains to direct ingest's bits."""
    its = _stream()
    bank = P.bank(capacity=2, backend="banked_pjit_coordinated",
                  mesh=P.mesh("tenants=2,estimators=2"), chunk_size=3)
    with P.Loop(bank) as loop:
        loop.add_tenant("a", seed=11).result(60)
        for W, nv in its[:6]:
            loop.submit("a", W, nv)
        loop.query("a").result(60)
        loop.drain(60)
        final = loop.query("a").result(60)
    return {"bank": {"a": tenant(bank, "a")}, "fixed": {"a": solo(P.fixed(11, its[:6]))},
            "final": _est(final["estimate"])}


def sc_from_other(P, snap):
    """A half-stream tenant snapshot of the other package, restored into
    this package's elastic bank and into a one-tenant engine, run on."""
    its = _stream()
    half = len(its) // 2
    bank = P.bank(capacity=2, backend="single", chunk_size=2)
    bank.hot_add("n", seed=40)
    bank.restore_tenant("x", snap)
    for i in range(half, len(its), 2):
        bank.ingest_chunk({"x": its[i:i + 2], "n": its[i:i + 1]})
    alone = P.from_snapshot(snap)
    for W, nv in its[half:]:
        alone.ingest(W, nv)
    return {"bank": {"x": tenant(bank, "x")}, "alone": solo(alone)}


def _half_snapshot(P, seed=21):
    its = _stream()
    bank = P.bank(capacity=2, backend="single")
    bank.hot_add("x", seed=seed)
    for W, nv in its[:len(its) // 2]:
        bank.ingest({"x": (W, nv)})
    return bank.snapshot_tenant("x")


# ---------------------------------------------------------------------------
# the JAX side (run as a script in its own process)
# ---------------------------------------------------------------------------
def _jax_side(out_path: str) -> None:
    import jax

    jax.config.update("jax_cpu_enable_async_dispatch", False)  # ROADMAP C.4
    import repro  # noqa: F401  -- x64

    assert jax.device_count() == 8, jax.device_count()
    J, port = Pkg("jax"), Pkg("port")
    res = {"churn": sc_churn(J), "snapshot_restore": sc_snapshot_restore(J),
           "crosses_fixed": sc_crosses_fixed(J), "empty_batch": sc_empty_batch(J),
           "evict_isolated": sc_evict_isolated(J), "rejects_unbanked": sc_rejects_unbanked(J),
           "local": sc_local(J), "serve_concurrent": sc_serve_concurrent(J),
           "backpressure": sc_backpressure(J), "fault_retried": sc_fault_retried(J),
           "evict_pending": sc_evict_pending(J), "sharded_serve": sc_sharded_serve(J)}
    for chunk in (1, 3):
        res[f"hot_add/{chunk}"] = sc_hot_add(J, chunk)
    snaps = {}
    for spec, backend, cap in SHARDED:
        out = sc_sharded(J, spec, backend, cap)
        snaps[backend] = out.pop("x_snapshot")
        res[f"sharded/{backend}"] = out
    res["cross_mesh"] = sc_cross_mesh(J, snaps["banked_pjit_independent"])
    snap_path = Path(out_path).with_suffix(".snap.npz")
    np.savez(snap_path, **_half_snapshot(J))
    res["snap_path"] = str(snap_path)
    res["from_port"] = sc_from_other(J, _half_snapshot(port))
    Path(out_path).write_text(json.dumps(res))


def _jax_cli(args) -> str:
    import jax

    jax.config.update("jax_cpu_enable_async_dispatch", False)
    from repro.engine import install_fault_plan as jax_install
    from repro.launch import stream_serve as jcli

    buf = io.StringIO()
    old = sys.argv
    sys.argv = ["stream_serve", *args]
    try:
        with redirect_stdout(buf):
            jcli.main()
    finally:
        sys.argv = old
        jax_install(None)
    return buf.getvalue()


def serve_lines(text: str) -> dict:
    """What the golden compares of a stream_serve run: the lines in order,
    but the ``session`` lines as a sorted list (sessions finish in thread
    order) and the ``served`` line without its seconds."""
    lines = [re.sub(r" in [0-9.]+s", "", ln) for ln in text.splitlines()
             if not ln.startswith("diag written")]
    return {"lines": [ln for ln in lines if not ln.startswith("session ")],
            "sessions": sorted(ln for ln in lines if ln.startswith("session "))}


def _fixed_lines(text: str) -> dict:
    return {"lines": [ln for ln in text.splitlines()
                      if ln.startswith(("stream:", "query step="))]}


def _write_golden() -> None:
    with tempfile.TemporaryDirectory() as d:
        elastic = serve_lines(_jax_cli([*CLI_ELASTIC, "--ckpt-dir", d]))
    golden = {"fixed": {"args": CLI_FIXED, **_fixed_lines(_jax_cli(CLI_FIXED))},
              "elastic": {"args": CLI_ELASTIC, **elastic}}
    GOLDEN.write_text(json.dumps(golden, indent=1) + "\n")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_elastic") / "ref.json"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, __file__, str(out)], env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(out.read_text())


@pytest.fixture(autouse=True)
def _no_faults():
    install_fault_plan(None)
    yield
    install_fault_plan(None)


@pytest.fixture(scope="module")
def port():
    return Pkg("port")


def _held(got: dict, want: dict) -> None:
    """Every tenant of the port's scenario equals the reference's elastic
    bank, the reference's one-tenant engine and the port's one-tenant
    engine."""
    for t, out in got["bank"].items():
        assert out == want["bank"][t], (t, "reference elastic bank")
        if t in want.get("fixed", {}):
            assert out == want["fixed"][t], (t, "reference one-tenant engine")
            assert out == got["fixed"][t], (t, "port one-tenant engine")


# ---------------------------------------------------------------------------
# the port side: the single plan
# ---------------------------------------------------------------------------
def _storage(bank) -> list:
    st = bank._state
    fields = [x for sh in st.shards for x in sh] if isinstance(st, ShardedState) else list(st)
    return [x.data_ptr() for x in fields] + [bank._root_keys.data_ptr()]


def test_churn_builds_one_tier_per_capacity_and_nothing_in_between(ref, port):
    """The reference's compile-once-per-capacity case: tier builds as the
    reference counts them, and within a capacity no kernel library built or
    loaded, no tier built, and every slot operation in place."""
    seen = {}

    def hook(bank, where):
        if where == "churn":
            seen["events"] = dict(LIBRARY_EVENTS)
            seen["tiers"] = bank.diag.tier_compiles
            return
        assert dict(LIBRARY_EVENTS) == seen["events"], "churn built or loaded a kernel"
        assert bank.diag.tier_compiles == seen["tiers"]

    got = sc_churn(port, hook)
    _held(got, ref["churn"])
    assert got["tiers"] == ref["churn"]["tiers"] == [1, [1, 2], [2, 1, 4], 2]
    assert got["diag"] == ref["churn"]["diag"]


@pytest.mark.parametrize("sharded", [False, True])
def test_slot_ops_write_in_place(sharded):
    """hot_add, evict, restore_tenant and snapshot_tenant keep every field's
    storage (each shard's on a sharded plan) and the root keys'."""
    its = _stream()
    kw = ({"backend": "banked_pjit_coordinated",
           "mesh": tmesh.make_stream_mesh("tenants=2,estimators=2", device="cpu",
                                          host_devices=8)}
          if sharded else {"backend": "single"})
    bank = ElasticBankEngine(R, S, capacity=4, device="cpu", **kw)
    bank.hot_add("a", seed=1)
    bank.ingest({"a": its[0]})
    before, events = _storage(bank), dict(LIBRARY_EVENTS)
    bank.hot_add("b", seed=2)
    snap = bank.snapshot_tenant("a")
    bank.evict("a")
    bank.restore_tenant("a", snap)
    bank.restore_tenant("c", snap)
    assert _storage(bank) == before
    assert dict(LIBRARY_EVENTS) == events and bank.diag.tier_compiles == 1
    assert state_sha256(bank.snapshot_tenant("c")) == state_sha256(snap)


def test_slot_keys_pair_each_cursor_with_its_own_slot():
    """``ingest`` folds ``fold_in(root_keys[c], steps[c])`` slot by slot
    (``rng.fold_in`` with (C, 2) keys and a (C,) tensor would fold every
    counter into every key)."""
    its = _stream()
    bank = ElasticBankEngine(R, S, capacity=4, backend="single", device="cpu")
    for i, t in enumerate("abc"):
        bank.hot_add(t, seed=10 + i)
        for W, nv in its[:i + 1]:
            bank.ingest({t: (W, nv)})
    want = torch.stack([rng.fold_in(bank._root_keys[c], int(bank._steps[c])) for c in range(4)])
    assert bank._steps.tolist() == [1, 2, 3, 0]
    assert torch.equal(bank._slot_keys(), want)


@pytest.mark.parametrize("chunk", [1, 3])
def test_hot_add_bit_identity_vs_fixed(ref, port, chunk):
    _held(sc_hot_add(port, chunk), ref[f"hot_add/{chunk}"])


def test_snapshot_restore_under_concurrent_ingest(ref, port):
    got, want = sc_snapshot_restore(port), ref["snapshot_restore"]
    _held(got, want)
    assert got["restored"] == got["at_snapshot"] == want["at_snapshot"]


def test_snapshot_crosses_into_fixed_engine(ref, port):
    _held(sc_crosses_fixed(port), ref["crosses_fixed"])


def test_empty_batch_is_a_state_noop(ref, port):
    got, want = sc_empty_batch(port), ref["empty_batch"]
    _held(got, want)
    assert got["bank"]["a"]["sha"] == got["before"]["sha"] == want["before"]["sha"]
    assert got["bank"]["a"]["step"] == got["before"]["step"] + 1


def test_eviction_isolated_from_neighbors(ref, port):
    got, want = sc_evict_isolated(port), ref["evict_isolated"]
    _held(got, want)
    assert got["b_before"] == want["b_before"]
    assert got["bank"]["b"]["sha"] == got["b_before"]["sha"]


def test_rejects_unbanked_plan(ref, port):
    got = sc_rejects_unbanked(port)
    assert got == ref["rejects_unbanked"] and "banked" in got["error"]


def test_local_scheme_bank(ref, port):
    _held(sc_local(port), ref["local"])


def test_tenant_snapshots_cross_between_packages(ref, port):
    """The reference's half-stream tenant snapshot continues in the port's
    bank and one-tenant engine; the port's in the reference's (run in the
    reference's process); each ends where a one-tenant engine of the full
    stream does."""
    full = solo(port.fixed(21, _stream()))
    with np.load(ref["snap_path"]) as z:
        got = sc_from_other(port, {k: z[k] for k in z.files})
    assert got["bank"]["x"] == got["alone"] == full
    assert ref["from_port"]["bank"]["x"] == ref["from_port"]["alone"] == full
    own = _half_snapshot(port)
    with np.load(ref["snap_path"]) as z:
        for k in z.files:
            np.testing.assert_array_equal(np.asarray(own[k]), z[k], err_msg=k)


def test_serve_loop_drained_equals_direct_ingest(ref, port):
    got, want = sc_serve_concurrent(port), ref["serve_concurrent"]
    _held(got, want)
    assert got["loop"] == want["loop"]
    assert got["loop"]["stale_age"] == 0 and got["loop"]["queries"] == 2
    assert got["loop"]["final"] == got["fixed"]["a"]["est"]


def test_backpressure_degrades_with_tagged_staleness(ref, port):
    got, want = sc_backpressure(port), ref["backpressure"]
    assert got == want
    assert got["stale"]["age"] >= 1 and got["stats"] == [1, got["stale"]["age"]]
    assert got["stale"]["est"] == got["fixed"]["after_1"]["est"]
    assert got["fresh"] == {"age": 0, "est": got["fixed"]["after_2"]["est"]}


def test_ingest_fault_is_retried(ref, port):
    got, want = sc_fault_retried(port), ref["fault_retried"]
    _held(got, want)
    assert got["retries"] == want["retries"] >= 1


def test_evict_drops_pending_and_restore_rejoins(ref, port):
    got = sc_evict_pending(port)
    assert got == ref["evict_pending"] == {"lost": 2, "backlog": 0}


def test_serve_loop_checkpointed_snapshot_and_restore(port, tmp_path):
    """``snapshot_tenant(save=True)`` writes through the verified store and
    ``restore_tenant(step=)`` brings the tenant back from it, under the
    traffic of a neighbour; the result is direct ingest's."""
    its = _stream()
    bank = port.bank(capacity=2, backend="single", chunk_size=2)
    with ElasticServeLoop(bank, checkpoint=str(tmp_path)) as loop:
        loop.add_tenant("a", seed=5).result(30)
        loop.add_tenant("b", seed=6).result(30)
        for W, nv in its[:4]:
            loop.submit("a", W, nv)
        loop.drain(30)
        snap = loop.snapshot_tenant("a", save=True).result(30)
        loop.evict_tenant("a").result(30)
        for W, nv in its:
            loop.submit("b", W, nv)
        assert loop.restore_tenant("a", step=int(snap["step"])).result(30) in (0, 1)
        for W, nv in its[4:]:
            loop.submit("a", W, nv)
        loop.drain(30)
    assert tenant(bank, "a") == solo(port.fixed(5, its))
    assert tenant(bank, "b") == solo(port.fixed(6, its))
    assert loop.report()["restores"] == 1 and loop.stats.control_ops == 5


# ---------------------------------------------------------------------------
# the port side: the tenant-sharded plans
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("spec,backend,cap", SHARDED)
def test_sharded_churn_grow_and_mixed_ingest(ref, port, spec, backend, cap):
    got = sc_sharded(port, spec, backend, cap)
    want = ref[f"sharded/{backend}"]
    got.pop("x_snapshot")
    _held(got, want)
    assert got["before_grow"] == want["before_grow"]
    assert got["grown"] == want["grown"] == [2 * cap, 2, 1]
    assert got["plan"] == backend
    assert got["est_a"] == got["gather_a"] == want["est_a"] == got["fixed"]["a"]["est"]


def test_sharded_snapshots_cross_meshes(ref, port):
    snap = sc_sharded(port, *SHARDED[0])["x_snapshot"]
    got, want = sc_cross_mesh(port, snap), ref["cross_mesh"]
    full = solo(port.fixed(11, _stream()))
    assert got == want and got["bank"]["x"] == got["alone"] == full


def test_sharded_serve_loop(ref, port):
    got, want = sc_sharded_serve(port), ref["sharded_serve"]
    _held(got, want)
    assert got["final"] == want["final"] == got["fixed"]["a"]["est"]


def test_grow_moves_slots_between_shards(port):
    """At capacity 4 on ``tenants=4`` slot 1 lives on shard 1; at capacity 8
    on shard 0. The grow re-places the bank, so slot 1's rows are shard 0's
    second tenant and equal what they were."""
    its = _stream()
    mesh = tmesh.make_stream_mesh("tenants=4", device="cpu", host_devices=8)
    bank = ElasticBankEngine(R, S, capacity=4, backend="banked_pjit_independent", mesh=mesh,
                             device="cpu")
    for i in range(4):
        bank.hot_add(i, seed=i)
        bank.ingest({i: its[i]})
    before = bank._state.shards[1].f1[0].clone()
    bank.hot_add(4, seed=4)
    assert bank.capacity == 8 and bank.slot_of(1) == 1
    assert torch.equal(bank._state.shards[0].f1[1], before)
    assert state_sha256(bank.snapshot_tenant(1)) == state_sha256(
        port.fixed(1, its[1:2]).snapshot())


# ---------------------------------------------------------------------------
# TenantQueues and the stdin thread, on both packages' objects
# ---------------------------------------------------------------------------
def _queues_cls(impl):
    if impl == "port":
        return TenantQueues
    from repro.data.prefetch import TenantQueues as JaxTenantQueues

    return JaxTenantQueues


IMPLS = ("port", "reference")


@pytest.mark.parametrize("impl", IMPLS)
class TestTenantQueues:
    def test_drop_policy_sheds_newest_and_counts(self, impl):
        q = _queues_cls(impl)(depth=2, policy="drop")
        q.add_tenant("a")
        assert q.put("a", 1) and q.put("a", 2)
        assert not q.put("a", 3)
        assert q.dropped == 1 and q.stalls == 0
        assert q.take("a", 3) == [1, 2]
        assert q.diag()["queue_dropped"] == 1

    def test_stall_policy_refuses_and_counts(self, impl):
        q = _queues_cls(impl)(depth=1, policy="stall")
        q.add_tenant("a")
        assert q.put("a", 1)
        assert not q.put("a", 2)
        assert q.stalls == 1 and q.dropped == 0
        q.take("a")
        assert q.put("a", 2)
        assert q.diag()["queue_stalls"] == 1

    def test_unknown_tenant_refused_and_eviction_counts_pending(self, impl):
        q = _queues_cls(impl)(depth=4)
        assert not q.put("ghost", 1)
        q.add_tenant("a")
        q.put("a", 1)
        q.put("a", 2)
        assert q.backlog() == 2 and q.backlog("a") == 2
        assert q.remove_tenant("a") == 2
        assert q.backlog() == 0 and q.tenants() == ()

    def test_take_is_front_packed_fifo(self, impl):
        q = _queues_cls(impl)(depth=8)
        q.add_tenant("a")
        for i in range(5):
            q.put("a", i)
        assert q.take("a", 3) == [0, 1, 2]
        assert q.take("a", 3) == [3, 4]
        assert q.take("a", 3) == []

    def test_diag_shape(self, impl):
        q = _queues_cls(impl)(depth=3, policy="stall")
        q.add_tenant("a")
        q.put("a", 1)
        assert q.diag() == {"queue_depth": 3, "queue_policy": "stall", "queue_dropped": 0,
                            "queue_stalls": 0, "queue_backlog": 1}

    def test_bad_arguments_raise(self, impl):
        cls = _queues_cls(impl)
        with pytest.raises(ValueError, match="depth"):
            cls(depth=0)
        with pytest.raises(ValueError, match="policy"):
            cls(policy="lifo")


@pytest.mark.parametrize("policy", ["drop", "stall"])
def test_tenant_queues_under_contention(policy):
    """8 producers and a consumer on one shortened switch interval: every
    put is either queued and taken once, or counted as shed or stalled."""
    import threading

    q = TenantQueues(depth=4, policy=policy)
    for t in range(2):
        q.add_tenant(t)
    accepted, taken, n_puts = [], [], 400
    stop = threading.Event()

    def produce(p):
        for i in range(n_puts):
            if q.put(p % 2, (p, i)):
                accepted.append((p, i))

    def consume():
        while not stop.is_set() or q.backlog():
            for t in range(2):
                taken.extend(q.take(t, 3))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        consumer = threading.Thread(target=consume)
        consumer.start()
        producers = [threading.Thread(target=produce, args=(p,)) for p in range(8)]
        for th in producers:
            th.start()
        for th in producers:
            th.join(60)
        stop.set()
        consumer.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not consumer.is_alive() and not any(th.is_alive() for th in producers)
    assert sorted(taken) == sorted(accepted) and q.backlog() == 0
    assert len(accepted) + q.dropped + q.stalls == 8 * n_puts
    assert (q.dropped if policy == "stall" else q.stalls) == 0


def _serve_module(impl):
    if impl == "port":
        return port_serve
    from repro.launch import stream_serve as jax_serve

    return jax_serve


@pytest.mark.parametrize("impl", IMPLS)
class TestStdinQueries:
    def _collect(self, q):
        out = []
        while not q.empty():
            out.append(q.get_nowait())
        return out

    def test_closed_stdin_posts_marker_not_quit(self, impl, monkeypatch):
        ss = _serve_module(impl)
        monkeypatch.setattr("sys.stdin", io.StringIO("1\nall\n"))
        q = queue.Queue()
        ss._stdin_queries(q)
        assert self._collect(q) == ["1", "all", ss._STDIN_CLOSED]
        assert ss._STDIN_CLOSED == port_serve._STDIN_CLOSED

    def test_quit_still_quits_without_marker(self, impl, monkeypatch):
        ss = _serve_module(impl)
        monkeypatch.setattr("sys.stdin", io.StringIO("quit\nignored\n"))
        q = queue.Queue()
        ss._stdin_queries(q)
        assert self._collect(q) == ["quit"]

    def test_errored_stdin_posts_error_marker(self, impl, monkeypatch):
        ss = _serve_module(impl)

        class Boom:
            def __iter__(self):
                return self

            def __next__(self):
                raise OSError("fd torn down")

        monkeypatch.setattr("sys.stdin", Boom())
        q = queue.Queue()
        ss._stdin_queries(q)
        (kind, msg), = self._collect(q)
        assert kind == ss._STDIN_ERROR == port_serve._STDIN_ERROR and "fd torn down" in msg


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
def _port_cli(args) -> str:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                                      os.environ.get("PYTHONPATH", "")]))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.stream_serve",
                           "--device", "cpu", *args], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300, check=True).stdout


def test_cli_fixed_bank_reproduces_golden():
    gold = json.loads(GOLDEN.read_text())["fixed"]
    assert _fixed_lines(_port_cli(gold["args"]))["lines"] == gold["lines"]


def test_cli_elastic_reproduces_golden(tmp_path):
    gold = json.loads(GOLDEN.read_text())["elastic"]
    got = serve_lines(_port_cli([*gold["args"], "--ckpt-dir", str(tmp_path)]))
    assert got == {"lines": gold["lines"], "sessions": gold["sessions"]}
    assert any("retries=1" in ln for ln in got["lines"])


def test_cli_elastic_is_insertion_only():
    with pytest.raises(SystemExit, match="insertion-only"):
        port_serve.main(["--device", "cpu", "--elastic", "--window", "10"])


def test_cli_without_a_gpu_needs_device_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_serve.main([*CLI_COMMON, "--elastic"])


if __name__ == "__main__":
    if sys.argv[1:] == ["--write"]:
        _write_golden()
    else:
        _jax_side(sys.argv[1])
