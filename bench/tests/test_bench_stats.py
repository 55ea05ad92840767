"""The metric arithmetic and the readers over a made-up window."""
import pytest

from bench import harness, stats
from bench.trace import TraceSummary


def test_rate_over_the_whole_window():
    assert stats.rate(3_000_000, 1.5) == 2_000_000
    assert stats.rate(0, 1.0) is None and stats.rate(10, 0.0) is None


def test_p95_over_every_sample():
    xs = list(range(1, 101))
    assert stats.percentile(xs, 95) == 95
    assert stats.percentile([5.0], 95) == 5.0
    assert stats.percentile(list(range(1, 21)), 95) == 19  # nearest rank: ceil(19.0)
    assert stats.percentile([], 95) is None
    assert stats.percentile([3, 1, 2], 100) == 3


def test_least_bytes():
    cfg = {"n_tenants": 1, "batch_size": 1 << 20, "r": 20_971_520, "chunk_size": 4}
    assert stats.least_bytes_per_batch(cfg) == 8 * (1 << 20) + 42 * 20_971_520 / 4
    bank = {"n_tenants": 4, "batch_size": 1 << 20, "r": 1 << 21, "chunk_size": 1}
    assert stats.least_bytes_per_batch(bank) == 4 * (8 * (1 << 20) + 42 * (1 << 21))
    assert stats.roofline_pct(3.35e9, 0.002, 3.35e12) == pytest.approx(50.0)
    assert stats.roofline_pct(1.0, 0.0, 3.35e12) is None


def _ctx(trace=None):
    w = harness.Window(seconds=2.0, jobs=3, handed=30, batches=30, edges=60_000_000,
                       latencies_ms=[float(i) for i in range(1, 41)])
    w.host_s.update({"ingest": 0.3, "ingest_chunk": 0.6, "stage_chunk": 0.3, "estimate": 0.5})
    w.calls.update({"ingest": 6, "ingest_chunk": 6, "stage_chunk": 6, "estimate": 10})
    w.service_s = 0.15
    cfg = {"n_tenants": 1, "batch_size": 1 << 20, "r": 1 << 21, "chunk_size": 4}
    return harness.Context({"name": "c"}, cfg, {}, 12.5, w, trace, {"hbm_bytes_per_s": 3.35e12})


def _read(name, ctx):
    return harness.load_reader(name)(ctx)


def test_end_to_end_readers():
    ctx = _ctx()
    assert _read("setup_s", ctx) == 12.5
    assert _read("edges_per_s", ctx) == 30_000_000
    assert _read("result_latency_p95_ms", ctx) == 38.0


def test_host_readers():
    ctx = _ctx()
    assert _read("service_host_ms_per_batch.global", ctx) == pytest.approx(5.0)
    assert _read("engine_host_ms_per_batch.bank", ctx) == pytest.approx(40.0)
    assert _read("estimate_ms", ctx) == pytest.approx(50.0)


def test_device_readers_need_a_trace():
    for name in ("update_busy_ms_per_batch.global", "update_roofline.global",
                 "estimate_busy_ms", "device_idle_pct.bank"):
        assert _read(name, _ctx()) is None
    t = TraceSummary(window_s=2.0, busy_s=1.5,
                     range_device_s={"ingest": 0.03, "ingest_chunk": 0.27, "estimate": 0.05})
    ctx = _ctx(t)
    assert _read("update_busy_ms_per_batch.global", ctx) == pytest.approx(10.0)
    assert _read("estimate_busy_ms", ctx) == pytest.approx(5.0)
    assert _read("device_idle_pct.global", ctx) == pytest.approx(25.0)
    least = 8 * (1 << 20) + 42 * (1 << 21) / 4
    assert _read("update_roofline.global", ctx) == pytest.approx(
        100 * least / 3.35e12 / 0.010)


def test_expected_steps():
    assert harness.expected_steps(37, 4, 8) == [8, 16, 24, 32, 37]
    assert harness.expected_steps(9, 4, 4) == [4, 8, 9]
    assert harness.expected_steps(3, 1, 1) == [1, 2, 3, 3]
    assert harness.expected_steps(2, 4, 8) == [2]  # a job shorter than a chunk
