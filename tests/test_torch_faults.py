"""The port's resilience layer against the JAX reference, at the sizes of
the reference's chaos tests (R = 512, BS = 32, an Erdos-Renyi stream of
m = 400 edges on n = 60 vertices).

Every loop test runs the same items under the same fault plan through both
packages, each plan installed through its own package's ``fault_plan``, and
holds the port to the reference: the final state's sha256 (and the window
ring's), ``step``, ``dyn_step``, ``edges_seen``, the gathered estimate, the
``StreamReport`` counters and the plans' summaries (calls, fired, log). The
log interleaves the producer thread's, the writer thread's and the loop's
entries in whatever order the threads ran, so it is compared as a set of
(site, kind, call number) entries; the per-site calls and fired counts are
compared as they are. The prefetch depth exceeds the stream's length, so
every producer runs to the end of its source and the ``prefetch.get`` call
counts do not depend on how far a producer got before a kill. Threads the
loops leave behind (the producer, an async checkpoint writer) are joined
with a bounded timeout before anything is compared. On the ``single`` plan
neither summary may show an ``engine.estimate`` call.

The kill-point chaos matrix is a fatal fault at each site x {insert, signed,
windowed} streams with checkpoints on disk, then a fresh engine that
resumes: it must end bit-identical to the unfaulted run. Killed in either
package, a stream resumes in the other from the same directory.
"""
import dataclasses
import random
import sys
import threading
import time

import numpy as np
import pytest
import torch

import repro  # noqa: F401  -- enables x64
from repro.engine import EngineConfig as JaxConfig
from repro.engine import FaultInjected as JaxFaultInjected
from repro.engine import ResilienceConfig as JaxResilience
from repro.engine import RetryPolicy as JaxRetryPolicy
from repro.engine import TriangleCountEngine as JaxEngine
from repro.engine import fault_plan as jax_fault_plan
from repro.engine import install_fault_plan as jax_install_fault_plan
from repro.engine import parse_fault_plan as jax_parse_fault_plan
from repro.engine import run_signed_stream as jax_run_signed_stream
from repro.engine import run_stream as jax_run_stream
from repro.engine import with_retries as jax_with_retries
from repro.engine.faults import FaultPlan as JaxFaultPlan
from repro.engine.faults import FaultSpec as JaxFaultSpec
from repro.engine.faults import active_fault_plan as jax_active_fault_plan
from repro.engine.service import StreamReport as JaxReport
from repro.engine.service import _answer_query as jax_answer_query
from repro.train.checkpoint import CheckpointManager as JaxCheckpointManager
from repro_torch.data.graph_stream import batches, churn_stream, erdos_renyi_stream, signed_batches
from repro_torch.engine import (
    EngineConfig,
    FaultInjected,
    FaultPlan,
    FaultSpec,
    ResilienceConfig,
    RetryPolicy,
    StreamReport,
    TriangleCountEngine,
    fault_plan,
    install_fault_plan,
    parse_fault_plan,
    run_signed_stream,
    run_stream,
    with_retries,
)
from repro_torch.engine.faults import active_fault_plan
from repro_torch.engine.service import _answer_query
from repro_torch.interop import state_sha256, window_sha256
from repro_torch.train.checkpoint import CheckpointManager

R, BS = 512, 32
STREAMS = ("insert", "signed", "windowed")
REPORT_FIELDS = ("batches", "edges", "resumed_from", "stale_batches", "phantom_batches",
                 "queries", "retries", "quarantined_batches", "duplicate_batches",
                 "degraded_queries", "max_staleness", "query_fallbacks")
JOIN_S = 30.0


@pytest.fixture(autouse=True)
def _no_leaked_plans():
    yield
    install_fault_plan(None)
    jax_install_fault_plan(None)


def er_edges(m=400, n=60, seed=0):
    return erdos_renyi_stream(n, m, seed=seed)


def stream_items(kind, edges=None):
    edges = er_edges() if edges is None else edges
    if kind == "signed":
        return list(signed_batches(churn_stream(edges, 0.3, seed=1), BS))
    return list(batches(edges, BS))


def port_engine(kind="insert", **kw):
    if kind == "windowed":
        kw["window"] = 100
    return TriangleCountEngine(EngineConfig(r=R, batch_size=BS, seeds=(0,), device="cpu", **kw))


def jax_engine(kind="insert", **kw):
    if kind == "windowed":
        kw["window"] = 100
    return JaxEngine(JaxConfig(r=R, batch_size=BS, n_tenants=1, seeds=(0,), **kw))


def port_runner(kind):
    return run_signed_stream if kind == "signed" else run_stream


def jax_runner(kind):
    return jax_run_signed_stream if kind == "signed" else jax_run_stream


def plans(spec: str):
    """The same grammar parsed by each package: (JAX plan, port plan)."""
    return jax_parse_fault_plan(spec), parse_fault_plan(spec)


def loop_threads() -> set:
    return {t for t in threading.enumerate()
            if getattr(getattr(t, "_target", None), "__name__", "") in ("_produce",
                                                                       "_write_guarded")}


class settled:
    """Join, with a bounded timeout, the producer and checkpoint-writer
    threads a block started (the loop returns or dies with them in
    flight)."""

    def __enter__(self):
        self.before = set(threading.enumerate())
        return self

    def __exit__(self, *exc):
        for t in loop_threads() - self.before:
            t.join(JOIN_S)
            assert not t.is_alive(), f"{t.name} still running after {JOIN_S}s"
        return False


def summary(plan) -> dict:
    s = plan.summary()
    assert "engine.estimate" not in s["calls"], "the single plan has no device query"
    return {**s, "log": sorted(map(tuple, s["log"]))}


def assert_same_plans(jplan, pplan):
    assert summary(pplan) == summary(jplan)


def assert_same_reports(prep, jrep):
    assert {f: getattr(prep, f) for f in REPORT_FIELDS} == \
        {f: getattr(jrep, f) for f in REPORT_FIELDS}
    assert prep.dead_letters.reasons() == jrep.dead_letters.reasons()


def assert_same_state(peng, jeng):
    """The two engines hold the same estimators, cursors and answers."""
    psnap, jsnap = peng.snapshot(), jeng.snapshot()
    assert state_sha256(psnap) == state_sha256(jsnap)
    if "window_edges" in jsnap:
        assert window_sha256(psnap) == window_sha256(jsnap)
    assert (peng.step, peng.dyn_step) == (jeng.step, jeng.dyn_step)
    np.testing.assert_array_equal(peng.edges_seen(), jeng.edges_seen())
    np.testing.assert_array_equal(peng.estimate(gather=True), jeng.estimate(gather=True))


def run_both(kind, items, spec, *, jax_kw=None, port_kw=None, fatal=False, jax=None,
             port=None, **common):
    """The same items under the same plan through both loops (``common``
    loop arguments for both, ``jax``/``port`` for one; engine arguments in
    ``jax_kw``/``port_kw``); returns ``(JAX engine, JAX report, port engine,
    port report)``, the reports None where the run died. Each plan stays
    installed until the threads its loop started have ended."""
    jplan, pplan = plans(spec)
    common.setdefault("prefetch_depth", len(items) + 1)
    jeng, peng = jax_engine(kind, **(jax_kw or {})), port_engine(kind, **(port_kw or {}))
    out = {}
    for name, eng, run, scope, exc, plan, args in (
            ("jax", jeng, jax_runner(kind), jax_fault_plan, JaxFaultInjected, jplan, jax),
            ("port", peng, port_runner(kind), fault_plan, FaultInjected, pplan, port)):
        with scope(plan), settled():
            if fatal:
                with pytest.raises(exc):
                    run(eng, iter(items), **common, **(args or {}))
            else:
                out[name] = run(eng, iter(items), **common, **(args or {}))
    if spec:
        assert_same_plans(jplan, pplan)
    return jeng, out.get("jax"), peng, out.get("port")


@pytest.fixture(scope="module")
def unfaulted():
    """``unfaulted(kind)``: the state sha256 of the unfaulted run of a
    stream, held to the JAX run once and kept for the module."""
    digests: dict = {}

    def digest(kind):
        if kind not in digests:
            jeng, jrep, peng, prep = run_both(kind, stream_items(kind), "")
            assert_same_reports(prep, jrep)
            assert_same_state(peng, jeng)
            digests[kind] = state_sha256(peng.snapshot())
        return digests[kind]

    return digest


# ---------------------------------------------------------------- chaos matrix
KILL_SPECS = {
    # times >> max_retries: the backoff is exhausted and the loop dies
    "engine.ingest": "engine.ingest:raise@5x999",
    "prefetch.get": "prefetch.get:raise@5x999",
    # a torn save #1 (its staging directory leaks, no manifest appears), then
    # a kill: the torn checkpoint is neither restored nor shadows the newest
    "checkpoint.write": "checkpoint.write:torn@1,engine.ingest:raise@7x999",
}


def dirs(tmp_path):
    return {"jax": {"ckpt_dir": str(tmp_path / "jax"), "ckpt_every": 2},
            "port": {"ckpt_dir": str(tmp_path / "port"), "ckpt_every": 2}}


@pytest.mark.parametrize("kind", STREAMS)
@pytest.mark.parametrize("site", tuple(KILL_SPECS))
def test_kill_and_recover_matches_jax(kind, site, tmp_path, unfaulted):
    items = stream_items(kind)
    jeng, _, peng, _ = run_both(kind, items, KILL_SPECS[site], fatal=True, **dirs(tmp_path))
    assert_same_state(peng, jeng)  # both died at the same point
    assert CheckpointManager(str(tmp_path / "port")).steps() == \
        JaxCheckpointManager(str(tmp_path / "jax")).steps()
    jrec, jrep, prec, prep = run_both(kind, items, "", **dirs(tmp_path))
    assert prep.resumed_from > 0, "the kill must land after a checkpoint"
    assert_same_reports(prep, jrep)
    assert_same_state(prec, jrec)
    assert state_sha256(prec.snapshot()) == unfaulted(kind)


@pytest.mark.parametrize("ingest", ["scan", "fused"])
def test_chunked_kill_and_recover_matches_jax(ingest, tmp_path, unfaulted):
    """K = 3: a staged but uningested chunk is not skipped on resume."""
    items = stream_items("insert")
    kw = {"jax_kw": {"chunk_size": 3}, "port_kw": {"chunk_size": 3, "ingest": ingest}}
    ck = {"jax": {"ckpt_dir": str(tmp_path / "jax"), "ckpt_every": 3},
          "port": {"ckpt_dir": str(tmp_path / "port"), "ckpt_every": 3}}
    jeng, _, peng, _ = run_both("insert", items, "engine.ingest_chunk:raise@2x999", fatal=True,
                                **kw, **ck)
    assert peng.step == jeng.step == 6
    assert_same_state(peng, jeng)
    jrec, jrep, prec, prep = run_both("insert", items, "", **kw, **ck)
    assert prep.resumed_from > 0
    assert_same_reports(prep, jrep)
    assert_same_state(prec, jrec)
    assert state_sha256(prec.snapshot()) == unfaulted("insert")


def test_stage_chunk_fault_is_retried():
    items = stream_items("insert")
    kw = {"jax_kw": {"chunk_size": 3}, "port_kw": {"chunk_size": 3}}
    jeng, jrep, peng, prep = run_both("insert", items, "engine.stage_chunk:raise@1", **kw)
    assert prep.retries == 1
    assert_same_reports(prep, jrep)
    assert_same_state(peng, jeng)


def test_unstaged_ingest_chunk_counts_both_sites():
    """``ingest_chunk`` on an unstaged chunk passes its own site, then
    ``stage_chunk``'s, as the reference does; a malformed chunk raises
    before either counts."""
    Ws = np.stack([W for W, _ in stream_items("insert")[:3]])
    jplan, pplan = plans("engine.stage_chunk:raise@0")
    jeng, peng = jax_engine(chunk_size=3), port_engine(chunk_size=3)
    with jax_fault_plan(jplan), fault_plan(pplan):
        with pytest.raises(JaxFaultInjected):
            jeng.ingest_chunk(Ws)
        with pytest.raises(FaultInjected):
            peng.ingest_chunk(Ws)
        for eng in (jeng, peng):
            with pytest.raises(ValueError):
                eng.stage_chunk(Ws[:2])
        jeng.ingest_chunk(Ws)
        peng.ingest_chunk(Ws)
    assert summary(pplan)["calls"] == {"engine.ingest_chunk": 2, "engine.stage_chunk": 2}
    assert_same_plans(jplan, pplan)
    assert_same_state(peng, jeng)


@pytest.mark.parametrize("spec", ["engine.ingest:raise@3x2", "prefetch.get:raise@2x2"])
def test_transient_faults_ridden_out(spec, unfaulted):
    """A fault shorter than the retry budget never surfaces: the same final
    state, the retries counted (in the loop or in the producer)."""
    items = stream_items("insert")
    jeng, jrep, peng, prep = run_both("insert", items, spec)
    assert prep.retries == 2
    assert_same_reports(prep, jrep)
    assert_same_state(peng, jeng)
    assert state_sha256(peng.snapshot()) == unfaulted("insert")


@pytest.mark.parametrize("kind", ["insert", "signed"])
def test_duplicate_delivery_deduped(kind, unfaulted):
    items = stream_items(kind)
    jeng, jrep, peng, prep = run_both(kind, items, "prefetch.get:dup@2x3")
    assert prep.duplicate_batches == 3
    assert_same_reports(prep, jrep)
    assert_same_state(peng, jeng)
    assert state_sha256(peng.snapshot()) == unfaulted(kind)


@pytest.mark.parametrize("method", ["ingest", "delete"])
def test_signed_loop_retries_ingest_and_delete(method, monkeypatch, unfaulted):
    """``run_signed_stream`` runs ``ingest`` and ``delete`` under the
    retries, as the reference does. ``delete`` passes no fault site, so its
    transient fault is raised by a wrapper: its third and fourth calls fail
    before anything is applied."""
    items = stream_items("signed")
    jeng, peng = jax_engine(), port_engine()
    reports = []
    for eng, exc, run, res in (
            (jeng, JaxFaultInjected, jax_run_signed_stream,
             JaxResilience(retry=JaxRetryPolicy(base_s=0.001))),
            (peng, FaultInjected, run_signed_stream,
             ResilienceConfig(retry=RetryPolicy(base_s=0.001)))):
        real, calls = getattr(eng, method), {"n": 0}

        def flaky(*args, real=real, calls=calls, exc=exc):
            calls["n"] += 1
            if calls["n"] in (3, 4):
                raise exc(f"engine.{method}", calls["n"])
            return real(*args)

        monkeypatch.setattr(eng, method, flaky)
        reports.append(run(eng, iter(items), resilience=res))
    jrep, prep = reports
    assert prep.retries == 2
    assert_same_reports(prep, jrep)
    assert_same_state(peng, jeng)
    assert state_sha256(peng.snapshot()) == unfaulted("signed")


def test_signed_chunk_fault_is_atomic():
    """``engine.ingest_signed_stream`` on the chunked path: the site fires
    before any state change, so a chunk killed mid-stream leaves the state
    and cursors at the point before it, and a clean rerun is exact."""
    edges = er_edges()
    ones = np.ones((len(edges), 1), np.int32)
    # long insert runs so the chunked path runs: 300 inserts, 40 deletions
    # of them, then the rest
    stream = np.concatenate([np.hstack([edges[:300], ones[:300]]),
                             np.hstack([edges[:40], -ones[:40]]),
                             np.hstack([edges[300:], ones[300:]])])
    items = list(signed_batches(stream, BS))
    jplan, pplan = plans("engine.ingest_chunk:raise@2")
    jeng, peng = jax_engine(chunk_size=3), port_engine(chunk_size=3)
    with jax_fault_plan(jplan), pytest.raises(JaxFaultInjected):
        jeng.ingest_signed_stream(iter(items))
    with fault_plan(pplan), pytest.raises(FaultInjected):
        peng.ingest_signed_stream(iter(items))
    assert peng.step == jeng.step == 2 * 3
    assert_same_plans(jplan, pplan)
    assert_same_state(peng, jeng)
    jclean, pclean = jax_engine(chunk_size=3), port_engine(chunk_size=3)
    jclean.ingest_signed_stream(iter(items))
    pclean.ingest_signed_stream(iter(items))
    assert_same_state(pclean, jclean)


def _poisoned(edges, bad_at=2):
    out = []
    for i, (W, nv) in enumerate(batches(edges, BS)):
        if i == bad_at:
            bad = W.copy()
            bad[0, 1] = bad[0, 0]  # a self-loop
            out.append((bad, nv))
        out.append((W, nv))
    return out


def test_quarantine_then_kill_then_resume_exact(tmp_path, unfaulted):
    """A quarantined batch moves the source position past ``step``; the
    resume is exactly-once all the same."""
    items = _poisoned(er_edges())
    jeng, _, peng, _ = run_both("insert", items, "engine.ingest:raise@7x999", fatal=True,
                                **dirs(tmp_path))
    assert_same_state(peng, jeng)
    jrec, jrep, prec, prep = run_both("insert", items, "", **dirs(tmp_path))
    assert prep.resumed_from > 0 and prep.quarantined_batches == 0  # quarantined before the cut
    assert_same_reports(prep, jrep)
    assert_same_state(prec, jrec)
    assert state_sha256(prec.snapshot()) == unfaulted("insert")


# ---------------------------------------------------------------- across packages
@pytest.mark.parametrize("spec", ["engine.ingest:raise@5x999",
                                  "checkpoint.write:torn@1,engine.ingest:raise@7x999"])
@pytest.mark.parametrize("killed_in", ["jax", "port"])
def test_killed_in_one_package_resumes_in_the_other(killed_in, spec, tmp_path):
    items = stream_items("insert")
    ck = {"ckpt_dir": str(tmp_path / "ck"), "ckpt_every": 2,
          "prefetch_depth": len(items) + 1}
    jplan, pplan = plans(spec)
    with settled():
        if killed_in == "jax":
            with jax_fault_plan(jplan), pytest.raises(JaxFaultInjected):
                jax_run_stream(jax_engine(), iter(items), **ck)
        else:
            with fault_plan(pplan), pytest.raises(FaultInjected):
                run_stream(port_engine(), iter(items), **ck)
    steps = CheckpointManager(ck["ckpt_dir"]).steps()
    # saves after batches 2, 4 and 6; with the torn one at 4 no manifest shows
    assert steps == ([2, 6] if "torn" in spec else [2, 4])
    assert not list((tmp_path / "ck").glob(".tmp_step_*"))
    with settled():
        if killed_in == "jax":
            eng = port_engine()
            rep = run_stream(eng, iter(items), **ck)
        else:
            eng = jax_engine()
            rep = jax_run_stream(eng, iter(items), **ck)
    assert rep.resumed_from == steps[-1] > 0
    ref = jax_engine()
    jax_run_stream(ref, iter(items))
    assert state_sha256(eng.snapshot()) == state_sha256(ref.snapshot())
    np.testing.assert_array_equal(eng.estimate(gather=True), ref.estimate(gather=True))


# ---------------------------------------------------------------- FaultPlan
GRAMMAR = ("engine.ingest:raise@3x2,checkpoint.write:torn@1,"
           "engine.estimate:delay@0x4~0.2,prefetch.get:dup@5,engine.stage_chunk:raise")


def test_parse_grammar_matches_jax():
    jplan, pplan = plans(GRAMMAR)
    assert [dataclasses.astuple(s) for s in pplan.specs] == \
        [dataclasses.astuple(s) for s in jplan.specs]
    s = pplan.specs
    assert (s[0].site, s[0].kind, s[0].at, s[0].times) == ("engine.ingest", "raise", 3, 2)
    assert (s[1].kind, s[1].at) == ("torn_write", 1)
    assert (s[2].kind, s[2].times, s[2].delay_s) == ("delay", 4, 0.2)
    assert (s[3].kind, s[3].at) == ("duplicate", 5)
    assert (s[4].at, s[4].times) == (0, 1)
    assert parse_fault_plan("") is None and parse_fault_plan("  ") is None
    assert summary(pplan) == summary(jplan)


@pytest.mark.parametrize("bad", ["nosuchsite:raise@0", "engine.ingest:explode@0",
                                 "engine.ingest", "engine.ingest:raise@x",
                                 "engine.ingest:raise@1x0", "engine.ingest:dup@0",
                                 "prefetch.get:torn@2", "engine.ingest:delay@0~soon"])
def test_parse_rejects_what_jax_rejects(bad):
    with pytest.raises(ValueError) as jerr:
        jax_parse_fault_plan(bad)
    with pytest.raises(ValueError) as perr:
        parse_fault_plan(bad)
    assert str(perr.value) == str(jerr.value)


def test_fault_spec_validation_matches_jax():
    for args in (("engine.ingest", "duplicate"), ("checkpoint.write", "dup"),
                 ("engine.ingest", "raise", 0, 0)):
        with pytest.raises(ValueError):
            JaxFaultSpec(*args)
        with pytest.raises(ValueError):
            FaultSpec(*args)


def test_counters_and_window_match_jax():
    outs = []
    for plan_cls, exc in ((FaultPlan, FaultInjected), (JaxFaultPlan, JaxFaultInjected)):
        spec_cls = FaultSpec if plan_cls is FaultPlan else JaxFaultSpec
        plan = plan_cls([spec_cls("engine.ingest", "raise", at=1, times=2),
                         spec_cls("engine.ingest", "delay", at=2, times=5, delay_s=0.001)],
                        seed=4)
        assert plan.check("engine.ingest") is None  # call 0
        for _ in range(2):  # calls 1, 2 fire; the first matching spec wins
            with pytest.raises(exc) as e:
                plan.check("engine.ingest")
        assert (e.value.site, e.value.shot) == ("engine.ingest", 2)
        assert plan.check("engine.ingest") is None  # call 3: the delay fires
        assert plan.check("prefetch.get") is None
        outs.append(plan.summary())
    port, ref = outs
    assert port == ref
    assert port["calls"] == {"engine.ingest": 4, "prefetch.get": 1}
    assert port["fired"] == {"engine.ingest": 3}
    assert port["log"] == [["engine.ingest", "raise", 1], ["engine.ingest", "raise", 2],
                           ["engine.ingest", "delay", 3]]


def test_fault_plan_is_thread_safe():
    """Concurrent checks from many threads lose no call and fire each shot
    once."""
    plan = FaultPlan([FaultSpec("engine.ingest", "raise", at=100, times=50)])
    fired = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(500):
                try:
                    plan.check("engine.ingest")
                except FaultInjected as e:
                    fired.append(e.shot)

        ts = [threading.Thread(target=work) for _ in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(JOIN_S)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    assert plan.calls["engine.ingest"] == 4000
    assert sorted(fired) == list(range(100, 150))


def test_context_restores_previous():
    for install, scope, active, plan_cls in (
            (install_fault_plan, fault_plan, active_fault_plan, FaultPlan),
            (jax_install_fault_plan, jax_fault_plan, jax_active_fault_plan, JaxFaultPlan)):
        outer = plan_cls([])
        install(outer)
        with scope(plan_cls([])):
            assert active() is not outer
        assert active() is outer
        with pytest.raises(KeyError):
            with scope(None):
                assert active() is None
                raise KeyError("body fails")
        assert active() is outer
        install(None)


def test_plans_of_the_two_packages_are_separate():
    """Each package's sites consult its own plan only."""
    with fault_plan(parse_fault_plan("engine.ingest:raise@0x9")):
        eng = jax_engine()
        eng.ingest(*stream_items("insert")[0])  # the JAX engine sees no plan
        assert jax_active_fault_plan() is None
        with pytest.raises(FaultInjected):
            port_engine().ingest(*stream_items("insert")[0])


# ---------------------------------------------------------------- RetryPolicy
def test_retries_then_succeeds():
    for policy, exc in ((RetryPolicy, FaultInjected), (JaxRetryPolicy, JaxFaultInjected)):
        calls = {"n": 0}

        def flaky():
            calls["n"] += 1
            if calls["n"] <= 2:
                raise exc("engine.ingest", calls["n"])
            return "ok"

        seen = []
        run = with_retries if policy is RetryPolicy else jax_with_retries
        assert run(policy(max_retries=3, base_s=0.001), flaky,
                   on_retry=lambda a, e: seen.append(a)) == "ok"
        assert seen == [0, 1]


def test_exhaustion_raises():
    calls = {"n": 0}

    def dead():
        calls["n"] += 1
        raise FaultInjected("engine.ingest", 0)

    with pytest.raises(FaultInjected):
        with_retries(RetryPolicy(max_retries=2, base_s=0.001), dead)
    assert calls["n"] == 3


@pytest.mark.parametrize("exc", [RuntimeError("CUDA error: an illegal memory access"),
                                 ValueError("not transient"), torch.cuda.OutOfMemoryError])
def test_non_retryable_propagates_at_once(exc):
    calls = {"n": 0}

    def bad():
        calls["n"] += 1
        raise exc

    with pytest.raises(type(exc) if isinstance(exc, BaseException) else exc):
        with_retries(RetryPolicy(max_retries=3, base_s=0.001), bad)
    assert calls["n"] == 1  # a replayed batch would bias m_seen
    assert RetryPolicy().retry_on == (FaultInjected,)


def test_none_policy_is_a_direct_call():
    assert with_retries(None, lambda: 7) == 7
    calls = {"n": 0}

    def once():
        calls["n"] += 1
        raise FaultInjected("engine.ingest", 0)

    with pytest.raises(FaultInjected):
        with_retries(None, once)
    assert calls["n"] == 1


def test_backoff_is_seeded_bounded_and_the_references():
    pol, jpol = (p(base_s=0.1, max_s=0.5, jitter=0.5, seed=3) for p in (RetryPolicy,
                                                                      JaxRetryPolicy))
    a = [pol.backoff_s(i, random.Random(3)) for i in range(6)]
    b = [pol.backoff_s(i, random.Random(3)) for i in range(6)]
    assert a == b == [jpol.backoff_s(i, random.Random(3)) for i in range(6)]
    assert all(0 < x <= 0.5 for x in a)


def test_retry_schedule_matches_jax(monkeypatch):
    """The sleeps between attempts are the reference's, jitter included."""
    import repro.engine.faults as jax_faults
    import repro_torch.engine.faults as port_faults

    slept = {"jax": [], "port": []}
    for name, mod, run, policy, exc in (
            ("jax", jax_faults, jax_with_retries, JaxRetryPolicy, JaxFaultInjected),
            ("port", port_faults, with_retries, RetryPolicy, FaultInjected)):
        monkeypatch.setattr(mod.time, "sleep", slept[name].append)

        def dead():
            raise exc("engine.ingest", 0)

        with pytest.raises(exc):
            run(policy(max_retries=5, base_s=0.01, max_s=0.1, seed=11), dead)
        monkeypatch.undo()
    assert slept["port"] == slept["jax"] and len(slept["port"]) == 5


def test_kernel_error_in_ingest_is_never_retried(monkeypatch):
    """A real exception from inside ``engine.ingest`` (a RuntimeError
    standing in for a CUDA error) propagates out of ``run_stream`` on its
    first attempt: no retry, no backoff, the batch applied nowhere."""
    eng = port_engine()
    calls = {"n": 0}

    def failing_update(*args, **kwargs):
        calls["n"] += 1
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(eng.scheme, "bulk_update", failing_update)
    plan = FaultPlan([])
    t0 = time.perf_counter()
    with fault_plan(plan), pytest.raises(RuntimeError, match="CUDA error"):
        run_stream(eng, iter(stream_items("insert")),
                   resilience=ResilienceConfig(retry=RetryPolicy(max_retries=3, base_s=1.0)))
    assert time.perf_counter() - t0 < 1.0  # no backoff slept
    assert calls["n"] == 1 and plan.summary()["calls"]["engine.ingest"] == 1
    assert eng.step == 0 and int(eng.edges_seen()[0]) == 0


# ---------------------------------------------------------------- queries
class _FakePF:
    def __init__(self, depth):
        self.depth = depth

    def backlog(self):
        return self.depth


def test_backpressure_serves_the_stale_cache_with_its_age():
    its = stream_items("insert")
    outs = []
    for eng, answer, report, res in (
            (port_engine(), _answer_query, StreamReport, ResilienceConfig(backpressure_depth=2)),
            (jax_engine(), jax_answer_query, JaxReport, JaxResilience(backpressure_depth=2))):
        eng.ingest(*its[0])
        first = eng.estimate()  # caches the step-1 answer
        eng.ingest(*its[1])  # now stale by one batch
        rep = report()
        astep, ests, age = answer(eng, _FakePF(2), res, rep, eng.step)
        assert (age, astep) == (1, eng.step - 1) and ests is first
        assert eng.cached_estimate()[0] == 1
        assert (rep.degraded_queries, rep.max_staleness) == (1, 1)
        # below the threshold: a fresh answer
        astep, fresh, age = answer(eng, _FakePF(1), res, rep, eng.step)
        assert (age, astep, rep.degraded_queries) == (0, eng.step, 1)
        np.testing.assert_array_equal(fresh, eng.estimate(gather=True))
        # at the threshold with a current cache: a plain hit
        astep, _, age = answer(eng, _FakePF(2), res, rep, eng.step)
        assert (age, rep.degraded_queries) == (0, 1)
        # off by default
        _, _, age = answer(eng, _FakePF(99), type(res)(), rep, eng.step)
        assert age == 0
        outs.append((first, fresh, dataclasses.asdict(eng.diag)))
    (pf, pn, pdiag), (jf, jn, jdiag) = outs
    np.testing.assert_array_equal(pf, jf)
    np.testing.assert_array_equal(pn, jn)
    assert pdiag == jdiag


def test_estimate_cache_and_diag_match_jax():
    """``queries_answered`` and ``query_cache_hits`` count as the
    reference's ``estimate`` does; ``gather=True`` recomputes and caches
    nothing; ``cached_estimate`` never queries; a deletion clears the
    cache; the diag is the reference's field for field."""
    its = stream_items("insert")
    diags = []
    for eng in (port_engine(), jax_engine()):
        assert eng.cached_estimate() is None
        eng.ingest(*its[0])
        eng.estimate(gather=True)
        assert eng.cached_estimate() is None
        a = eng.estimate()
        assert eng.estimate() is a and eng.estimate_tenant(0) == float(a[0])
        eng.estimate_tenants([0])
        eng.estimate(timeout_s=0.001)  # no device query on single: nothing to bound
        eng.ingest(*its[1])
        assert eng.cached_estimate()[0] == 1
        eng.delete(its[1][0][:4])
        assert eng.cached_estimate() is None
        eng.estimate()
        diags.append(dataclasses.asdict(eng.diag))
    assert diags[0] == diags[1]
    assert diags[0]["backend"] == "single"
    assert (diags[0]["queries_answered"], diags[0]["query_cache_hits"]) == (7, 4)


@pytest.mark.parametrize("kind", ["insert", "signed"])
def test_run_backpressure_state_unaffected(kind, unfaulted):
    """Stale answers never touch the state: the bank equals an unthrottled
    run, and the ages reach the ``stale_age`` keyword."""
    items = stream_items(kind)
    ages = {"jax": [], "port": []}

    def cb(which):
        def on_report(step, ests, seen, stale_age=0):
            ages[which].append((step, stale_age))
        return on_report

    run = {"report_every": 1}
    jeng, jrep, peng, prep = run_both(
        kind, items, "", jax={**run, "on_report": cb("jax"),
                              "resilience": JaxResilience(backpressure_depth=1)},
        port={**run, "on_report": cb("port"),
              "resilience": ResilienceConfig(backpressure_depth=1)})
    for rep, seen in ((prep, ages["port"]), (jrep, ages["jax"])):
        assert rep.queries == len(seen)
        assert rep.degraded_queries == sum(1 for _, a in seen if a > 0)
        assert rep.max_staleness == max((a for _, a in seen), default=0)
    assert_same_state(peng, jeng)
    assert state_sha256(peng.snapshot()) == unfaulted(kind)


def test_three_argument_callbacks_still_work():
    calls = []
    eng = port_engine()
    rep = run_stream(eng, batches(er_edges(m=96), BS), report_every=1,
                     on_report=lambda s, e, m: calls.append(s))
    assert calls == [1, 2, 3] and rep.queries == 3
    jcalls = []
    jax_run_stream(jax_engine(), batches(er_edges(m=96), BS), report_every=1,
                   on_report=lambda s, e, m: jcalls.append(s))
    assert jcalls == calls


def test_report_answers_match_jax():
    """Fresh report answers under a transient fault: the same (step,
    estimates, edges_seen) in both packages, each answer the gathered
    estimate at its step."""
    items = stream_items("insert")
    got = {"jax": [], "port": []}

    def cb(which):
        return lambda s, e, m: got[which].append((s, e.tolist(), m.tolist()))

    kw = {"report_every": 2}
    run_both("insert", items, "engine.ingest:raise@3",
             jax={**kw, "on_report": cb("jax")}, port={**kw, "on_report": cb("port")})
    assert got["port"] == got["jax"] and len(got["port"]) == 6


def test_backpressure_answers_match_jax():
    """Backpressure by construction: a query before the stream caches the
    step-0 answer, and a delay before the first chunk's ingest lets the
    producer queue the whole stream, so the reports at steps 3, 6 and 9 find
    a backlog and are served from the cache, aged 3, 6 and 9; at 12 and 13
    the queue is empty and the answers fresh. Both packages serve the same
    answers with the same ages, and each stale answer is the step-0 one."""
    items = stream_items("insert")
    got = {"jax": [], "port": []}

    def cb(which):
        def on_report(step, ests, seen, stale_age=0):
            got[which].append((step, stale_age, ests.tolist()))
        return on_report

    jeng, peng = jax_engine(chunk_size=3), port_engine(chunk_size=3)
    first = {"jax": jeng.estimate().tolist(), "port": peng.estimate().tolist()}
    jplan, pplan = plans("engine.ingest_chunk:delay@0~0.3")
    kw = {"report_every": 1, "prefetch_depth": len(items) + 1}
    with jax_fault_plan(jplan), settled():
        jrep = jax_run_stream(jeng, iter(items), on_report=cb("jax"), **kw,
                              resilience=JaxResilience(backpressure_depth=1))
    with fault_plan(pplan), settled():
        prep = run_stream(peng, iter(items), on_report=cb("port"), **kw,
                          resilience=ResilienceConfig(backpressure_depth=1))
    assert_same_plans(jplan, pplan)
    assert_same_reports(prep, jrep)
    assert got["port"] == got["jax"]
    assert [(s, a) for s, a, _ in got["port"]] == [(0, 3), (0, 6), (0, 9), (12, 0), (13, 0)]
    assert all(e == first["port"] for _, a, e in got["port"] if a > 0)
    assert (prep.degraded_queries, prep.max_staleness, prep.queries) == (3, 9, 5)
    assert_same_state(peng, jeng)
