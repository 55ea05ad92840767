"""The port's span recorder (``repro_torch.spans``): off by default and a
shared no-op while off; on, nested records with their parents, per-thread
stacks, stream and step; on while a profiler runs; its anchor on the
profiler's clock; the spans each ingest route records under
``run_stream``; and the bits, equal with tracing on and off. Everything
runs on the CPU at a tiny size."""
import threading
import time
from collections import Counter

import numpy as np
import pytest
import torch

from repro_torch import spans
from repro_torch.data.graph_stream import batches, planted_triangle_stream
from repro_torch.engine import EngineConfig, TriangleCountEngine, run_stream

R, S = 512, 64


@pytest.fixture
def recording():
    spans.enable()
    try:
        yield
    finally:
        spans.take()
        spans.disable()


def _edges():
    edges, _ = planted_triangle_stream(40, 700, 900, seed=3)
    return edges  # 820 edges: 12 full batches of 64 and a ragged one of 52


def _engine(K):
    return TriangleCountEngine(EngineConfig(r=R, batch_size=S, chunk_size=K, seeds=(5,),
                                            device="cpu"))


def _stream(K, every=4):
    """A stream through ``run_stream``: the engine, its answers, the report."""
    eng, answers = _engine(K), []
    rep = run_stream(eng, batches(_edges(), S), report_every=every,
                     on_report=lambda step, est, seen: answers.append((step, est.copy())))
    answers.append((eng.step, eng.estimate().copy()))
    return eng, answers, rep


def test_off_by_default_records_nothing():
    assert spans.span("core.build") is spans.span("service.stack") is spans._OFF
    assert spans.stream(lambda: 0) is spans._OFF
    with spans.span("core.build") as s:
        assert s is None
    _stream(4)
    assert spans.take()[0] == []


def _profiled(names):
    """Open a span of each of ``names`` under a CPU profiler; the profiler's
    event names."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for name in names:
            assert spans.span(name) is not spans._OFF
            with spans.span(name):
                pass
    return {e.name() for e in prof.profiler.kineto_results.events()}


def test_records_while_a_profiler_runs():
    assert spans.span("a") is spans._OFF
    events = _profiled(["a", "b"])
    assert spans.span("c") is spans._OFF  # the session has ended
    _profiled(["d"])  # a new session starts a fresh list
    recs, anchor = spans.take()
    assert [r.name for r in recs] == ["d"] and recs[0].end is not None
    assert abs(anchor - (time.time_ns() - time.perf_counter_ns())) < 50_000_000
    assert not events & {"a", "b"}  # nothing goes into the profiler's trace
    assert spans.take()[0] == []


def test_records_nest_per_thread_and_close_on_an_exception(recording):
    seen = {}

    def worker():
        with spans.span("worker.outer"):
            with spans.span("worker.inner"):
                pass
        seen["tid"] = threading.get_native_id()

    with spans.stream(lambda: 7):
        with spans.span("a"):
            with spans.span("b"):
                t = threading.Thread(target=worker)
                t.start()
                t.join(timeout=10)
            with pytest.raises(KeyError), spans.span("c"):
                raise KeyError("x")
            with spans.span("d"):
                pass
    assert not t.is_alive()
    with spans.span("e"):
        pass
    recs, anchor = spans.take()
    by = {r.name: (i, r) for i, r in enumerate(recs)}
    assert sorted(by) == ["a", "b", "c", "d", "e", "worker.inner", "worker.outer"]
    ia, a = by["a"]
    assert a.parent == -1
    assert by["b"][1].parent == by["c"][1].parent == by["d"][1].parent == ia
    assert by["worker.outer"][1].parent == -1  # the other thread's stack is its own
    assert by["worker.inner"][1].parent == by["worker.outer"][0]
    assert by["worker.outer"][1].thread == seen["tid"] != a.thread
    c = by["c"][1]
    assert c.end is not None and c.start <= c.end <= by["d"][1].start  # closed by the raise
    for r in recs:
        assert r.end is not None and r.start <= r.end
    assert {(r.stream, r.step) for n, (_, r) in by.items() if n in "abcd"} == {(a.stream, 7)}
    assert a.stream is not None
    assert by["e"][1].stream is None and by["e"][1].step is None
    assert by["worker.outer"][1].stream is None
    assert abs(anchor - (time.time_ns() - time.perf_counter_ns())) < 50_000_000


def test_anchor_puts_a_span_on_the_profilers_clock(recording):
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(3):
            with spans.span("probe"), torch.profiler.record_function("probe_range"):
                time.sleep(0.002)
    recs, anchor = spans.take()
    ranges = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                    for e in prof.profiler.kineto_results.events()
                    if e.name() == "probe_range")
    assert len(ranges) == len(recs) == 3
    for r, (a, b) in zip(recs, ranges):
        assert abs(r.start + anchor - a) < 1_000_000
        assert abs(r.end + anchor - b) < 1_000_000


def test_each_route_records_its_spans(recording):
    n_batches = 13  # 12 full and a ragged one
    for K, every in ((4, 4), (1, 1)):
        spans.take()
        eng, answers, rep = _stream(K, every)
        recs, _ = spans.take()
        got = Counter(r.name for r in recs)
        chunks, single = (3, 1) if K == 4 else (0, n_batches)
        assert rep.batches == n_batches and chunks * K + single == n_batches
        queries = len({step for step, _ in answers})
        assert got["service.validate"] == n_batches
        assert got["service.prefetch_wait"] == n_batches + 1  # the last get ends the stream
        assert got["service.stack"] == chunks
        assert got["core.fused_ingest"] == chunks
        assert got["core.build"] == chunks + single
        # the chunk route draws once a chunk, the per-batch route 3 times a batch
        assert got["core.draw"] == chunks + 3 * single
        assert got["core.search"] == 3 * n_batches  # in fused_batch on the plain chunk route
        assert got["engine.upload"] == 2 * chunks + single  # a chunk's edges and counts
        assert got["query.compute"] == got["query.to_host"] == queries
        stream_ids = {r.stream for r in recs if not r.name.startswith("query.")}
        assert len(stream_ids) == 1 and None not in stream_ids
        # the final estimate runs after run_stream, outside its stream
        assert {r.stream for r in recs if r.name.startswith("query.")} <= stream_ids | {None}
        # the spans of one engine call share (stream, step)
        fused = [r for r in recs if r.name == "core.fused_ingest"]
        builds = [r for r in recs if r.name == "core.build"]
        assert [r.step for r in builds[:chunks]] == [4 * i for i in range(chunks)]
        assert [r.step for r in fused] == [4 * i for i in range(chunks)]
        assert [r.step for r in builds[chunks:]] == list(range(4 * chunks, n_batches))
        parents = {recs[r.parent].name if r.parent >= 0 else None
                   for r in recs if r.name == "core.search"}
        assert parents == ({"core.fused_ingest", None} if K == 4 else {None})


def test_tracing_keeps_the_bits():
    for K in (1, 4):
        off_eng, off_answers, _ = _stream(K)
        spans.enable()
        try:
            on_eng, on_answers, _ = _stream(K)
            recs, _ = spans.take()
        finally:
            spans.disable()
        assert recs
        for f in ("f1", "chi", "f2", "has_f3", "m_seen"):
            assert torch.equal(getattr(off_eng.state, f), getattr(on_eng.state, f)), f
        assert [s for s, _ in off_answers] == [s for s, _ in on_answers]
        for (_, a), (_, b) in zip(off_answers, on_answers):
            np.testing.assert_array_equal(a, b)
