"""Spans: host intervals recorded at the port's layer boundaries, so a run
can be traced from inside the program.

The operator's API::

    from repro_torch import spans

    spans.enable()                   # start recording (drops older records)
    ...                              # the work: run_stream, engine calls
    records, anchor = spans.take()   # the records so far, and the clock anchor
    spans.disable()                  # stop recording

Recording is on after ``enable()``, and also, without it, for as long as a
``torch.profiler`` session runs: a profiler session that begins while
``enable()`` is not in force starts a fresh list, and its records stay there
for ``take()`` once it has ended. So a run traced under the profiler (the
benchmark's ``--trace 1``) gets the program's spans of exactly its profiled
window, and an untraced run records nothing.

Off (the default), ``span(name)`` returns one shared no-op context manager:
no clock read, no allocation, no ``torch.profiler.record_function``; it
only asks the profiler whether it runs. On, each span appends one ``Span``
to an in-memory list when it opens and stamps its end when it closes, an
exception included. Nothing is written to disk, and nothing goes into the
profiler's own trace.

A ``Span`` holds its name, its start and end in ``time.perf_counter_ns()``,
the index (in the records) of the span it opened inside on the same thread,
or -1, the native thread id, and the stream and step it ran under:
``stream(cursor)`` (one per ``run_stream`` call) numbers a stream on its
thread, and each span opened inside it reads ``cursor()``, the engine's
position, when it opens, so the spans of one engine call share
``(stream, step)``. Outside a stream both are None.

``anchor`` is ``time.time_ns() - time.perf_counter_ns()``, read back to
back when recording starts: ``start + anchor`` is a span's start on the
Unix-epoch nanosecond clock in which ``torch.profiler`` (kineto) stamps its
host events, which lines the spans up with a device trace.

The spans (layer, then stage): ``service.prefetch_wait``,
``service.validate``, ``service.stack``, ``engine.upload``, ``core.build``,
``core.draw``, ``core.search``, ``core.fused_ingest``, ``query.compute``,
``query.to_host``.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Optional

import torch

_profiling = torch._C._autograd._profiler_enabled  # whether a profiler session runs


class Span:
    """One recorded interval (see the module docstring), and while recording
    is on the context manager that records it. Until ``take()`` hands it
    over, ``parent`` holds the enclosing ``Span`` itself."""

    __slots__ = ("name", "start", "end", "parent", "thread", "stream", "step")

    def __init__(self, name: str):
        self.name = name
        self.start = self.end = self.parent = self.thread = self.stream = self.step = None

    def __enter__(self):
        t = _thread
        stack = t.stack
        self.parent = stack[-1] if stack else None
        self.thread = t.tid
        if t.stream is not None:
            self.stream, self.step = t.stream[0], t.stream[1]()
        _rec.records.append(self)
        stack.append(self)
        self.start = time.perf_counter_ns()
        return None

    def __exit__(self, *exc) -> bool:
        self.end = time.perf_counter_ns()
        _thread.stack.pop()
        return False


class _Off:
    """The shared no-op context manager of a span while recording is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


class _Recorder:
    """The process's one recorder: the records and the anchor."""

    def __init__(self):
        self.on = False  # enable() is in force
        self.following = False  # recording for the profiler session that runs
        self.records: list = []
        self.anchor = 0
        self.streams = 0
        self.lock = threading.Lock()


class _Thread(threading.local):
    """Per thread: the open spans, innermost last, the native thread id and
    the current stream, (id, cursor) or None."""

    def __init__(self):
        self.stack: list = []
        self.tid = threading.get_native_id()
        self.stream: Optional[tuple] = None


_rec = _Recorder()
_thread = _Thread()


class _Stream:
    """``stream(cursor)`` while recording is on."""

    __slots__ = ("cursor", "prev")

    def __init__(self, cursor: Callable[[], int]):
        self.cursor = cursor

    def __enter__(self):
        with _rec.lock:
            _rec.streams += 1
            sid = _rec.streams
        self.prev = _thread.stream
        _thread.stream = (sid, self.cursor)
        return None

    def __exit__(self, *exc) -> bool:
        _thread.stream = self.prev  # drops the cursor: it may hold an engine
        return False


def _recording() -> bool:
    """Whether a span opened now records (see the module docstring)."""
    r = _rec
    if r.on:
        return True
    if _profiling():
        if not r.following:
            _start(following=True)
        return True
    r.following = False
    return False


def span(name: str):
    """A context manager recording ``name`` over its body while recording
    is on; the shared no-op while it is off."""
    return Span(name) if _recording() else _OFF


def stream(cursor: Callable[[], int]):
    """Number a new stream on this thread for the spans opened inside;
    ``cursor()`` gives the step each span records. The no-op while off."""
    return _Stream(cursor) if _recording() else _OFF


def _start(following: bool) -> None:
    """Start recording afresh: for ``enable()``, or for the profiler
    session that runs, once, whichever thread sees it first."""
    with _rec.lock:
        if following and _rec.following:
            return
        _rec.records = []
        _rec.anchor = time.time_ns() - time.perf_counter_ns()
        _rec.following = following
        _rec.on = not following


def enable() -> None:
    """Start recording, dropping older records, and read the anchor."""
    _start(following=False)


def disable() -> None:
    """Stop recording; spans already open still stamp their ends."""
    _rec.on = False


def take() -> tuple[list, int]:
    """``(records, anchor)``: the records since recording started (or the
    last ``take()``), in the order the spans opened, handed over and cleared,
    each ``parent`` turned into its index there (-1 where the enclosing span
    is not among them). A span still open has ``end`` None until it
    closes."""
    with _rec.lock:
        records, _rec.records = _rec.records, []
        anchor = _rec.anchor
    index = {id(r): i for i, r in enumerate(records)}
    for r in records:
        if not isinstance(r.parent, int):
            r.parent = -1 if r.parent is None else index.get(id(r.parent), -1)
    return records, anchor
