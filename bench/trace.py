"""Reading a ``torch.profiler`` trace of the measured window.

The harness opens ``record_function`` ranges named ``bench.<what>`` around
its calls into the program (``bench.window`` around the whole window). From
the profiler's raw events (``kineto_results``, as the repository's
``chip_smoke.device_ops`` reads them; building ``prof.events()`` takes
minutes at this size) this module takes:

  * the device's busy time: the union of every device operation's interval
    inside the window (two streams overlapping count once);
  * the idle gaps, each named by the innermost harness range open on the
    host at the gap's middle;
  * each device operation's own range: the innermost harness range open
    when the host issued it (its CUDA runtime call, matched by correlation
    id), so a layer's device time is what its calls launched;
  * the device operations' summed time by name.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

PREFIX = "bench."


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    range_device_s: dict = field(default_factory=dict)  # harness range -> device s launched
    ops: dict = field(default_factory=dict)  # device op name -> (count, s)
    gaps: dict = field(default_factory=dict)  # harness range -> (count, idle s)
    longest_gaps: list = field(default_factory=list)  # [(range, s)] longest first
    device_ops: int = 0
    unattributed_device_s: float = 0.0


def _innermost(ranges: list, points: list) -> list:
    """For each of ``points`` (sorted ascending), the name of the innermost
    range (start, end, name) that contains it, or None. Ranges opened on one
    thread nest or are disjoint, so a sweep keeps the open ones on a stack:
    once those that closed before a point are popped, the top holds it."""
    ranges = sorted(ranges, key=lambda x: (x[0], -x[1]))
    out, stack, i = [], [], 0
    for p in points:
        while i < len(ranges) and ranges[i][0] <= p:
            stack.append(ranges[i])
            i += 1
        while stack and stack[-1][1] < p:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


def summarize(prof, window: str = PREFIX + "window") -> TraceSummary:
    """The window's device timeline, read from ``prof``'s raw events."""
    events = list(prof.profiler.kineto_results.events())
    cuda = torch.autograd.DeviceType.CUDA
    ranges, launches, dev = [], {}, []
    for e in events:
        name = e.name()
        if e.device_type() == cuda:
            # the device-side copies of the harness's ranges are no operations
            if not e.is_hidden_event() and not name.startswith(PREFIX):
                dev.append((e.start_ns(), e.start_ns() + e.duration_ns(), name,
                            e.correlation_id(), e.linked_correlation_id()))
            continue
        if name.startswith(PREFIX):
            ranges.append((e.start_ns(), e.start_ns() + e.duration_ns(), name[len(PREFIX):]))
        elif name.startswith("cu") and e.correlation_id():  # a CUDA runtime or driver call
            launches[e.correlation_id()] = e.start_ns()
    win = [r for r in ranges if r[2] == window[len(PREFIX):]]
    if not win:
        raise ValueError(f"the trace has no {window!r} range")
    w0, w1 = win[0][0], win[0][1]
    inner = [r for r in ranges if r[2] != window[len(PREFIX):]]

    dev = sorted((max(a, w0), min(b, w1), n, c, lc) for a, b, n, c, lc in dev
                 if b > w0 and a < w1)
    busy, gaps, cursor = 0, [], w0
    for a, b, *_ in dev:
        if a > cursor:
            gaps.append((cursor, a))
        if b > cursor:
            busy += b - max(a, cursor)
            cursor = b
    if cursor < w1:
        gaps.append((cursor, w1))

    s = TraceSummary(window_s=(w1 - w0) / 1e9, busy_s=busy / 1e9, device_ops=len(dev))
    names = _innermost(inner, [(a + b) // 2 for a, b in gaps])
    for (a, b), n in zip(gaps, names):
        n = n or "harness"
        k, t = s.gaps.get(n, (0, 0.0))
        s.gaps[n] = (k + 1, t + (b - a) / 1e9)
    s.longest_gaps = sorted(((n or "harness", (b - a) / 1e9)
                             for (a, b), n in zip(gaps, names)), key=lambda x: -x[1])[:10]

    issued = []
    for a, b, n, c, lc in dev:
        k, t = s.ops.get(n, (0, 0.0))
        s.ops[n] = (k + 1, t + (b - a) / 1e9)
        at = launches.get(c, launches.get(lc))
        issued.append((at, (b - a) / 1e9))
    known = sorted((at, d) for at, d in issued if at is not None)
    s.unattributed_device_s = sum(d for at, d in issued if at is None)
    for (at, d), n in zip(known, _innermost(inner, [at for at, _ in known])):
        n = n or "harness"
        s.range_device_s[n] = s.range_device_s.get(n, 0.0) + d
    return s


def top_ops(summary: TraceSummary, n: int = 10) -> list:
    """The n device operations that took most time: [[name, seconds]]."""
    ranked = sorted(summary.ops.items(), key=lambda kv: -kv[1][1])[:n]
    return [[name[:120], secs] for name, (_, secs) in ranked]


def gap_table(summary: TraceSummary, n: int = 10) -> list:
    """Idle time by what the host was doing: [[range, seconds]], most first."""
    ranked = sorted(summary.gaps.items(), key=lambda kv: -kv[1][1])[:n]
    return [[name, secs] for name, (_, secs) in ranked]
