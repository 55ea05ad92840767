"""The trace reader's sweep and its arithmetic on made-up events."""
from types import SimpleNamespace

import torch

from bench import trace


def test_innermost_nested_and_disjoint():
    ranges = [(0, 100, "job"), (10, 50, "run_stream"), (20, 30, "ingest"),
              (60, 70, "final"), (120, 130, "job")]
    pts = [5, 25, 40, 55, 65, 110, 125]
    assert trace._innermost(ranges, pts) == ["job", "ingest", "run_stream", "job", "final",
                                             None, "job"]


class _Ev:
    def __init__(self, name, start, dur, cuda=False, corr=0):
        self._n, self._s, self._d, self._c, self._k = name, start, dur, cuda, corr

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._c else torch.autograd.DeviceType.CPU

    def is_hidden_event(self):
        return False

    def correlation_id(self):
        return self._k

    def linked_correlation_id(self):
        return 0


def test_summarize_busy_gaps_and_attribution():
    ev = [
        _Ev("bench.window", 0, 1000),
        _Ev("bench.ingest", 100, 200),
        _Ev("bench.estimate", 500, 100),
        _Ev("cudaLaunchKernel", 150, 5, corr=1),
        _Ev("cudaLaunchKernel", 160, 5, corr=2),
        _Ev("cudaMemcpyAsync", 520, 5, corr=3),
        _Ev("k1", 200, 100, cuda=True, corr=1),
        _Ev("k2", 250, 150, cuda=True, corr=2),  # overlaps k1: counted once
        _Ev("Memcpy DtoH", 550, 50, cuda=True, corr=3),
        _Ev("bench.ingest", 200, 50, cuda=True),  # a range's device copy: not an op
    ]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: ev)))
    s = trace.summarize(prof)
    assert s.window_s == 1e-6 and abs(s.busy_s - 250e-9) < 1e-15
    assert s.device_ops == 3
    assert abs(s.range_device_s["ingest"] - 250e-9) < 1e-15
    assert abs(s.range_device_s["estimate"] - 50e-9) < 1e-15
    gaps = dict(trace.gap_table(s))
    assert abs(gaps["ingest"] - 200e-9) < 1e-15  # 0..200: its middle is inside bench.ingest
    assert abs(gaps["harness"] - (150e-9 + 400e-9)) < 1e-15
    assert set(gaps) == {"ingest", "harness"}
    assert [n for n, _ in trace.top_ops(s)] == ["k2", "k1", "Memcpy DtoH"]
