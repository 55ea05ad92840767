"""Deterministic fault injection, bounded retries and batch validation
for the service loops (``repro.engine.faults``).

Why the service needs a chaos harness: the estimator is one-pass, and
``m_seen`` is its unbiasedness weight, so a batch that is dropped, replayed
or restored from a torn snapshot biases every later answer, and nothing
downstream can repair it. ``FaultPlan`` kills the loop deterministically at
each seam so that tests can prove a recovered run ends bit-identical to an
unfaulted one.

Fault sites; each fires before the state change it guards, so a retried
call replays no edges:

  ``prefetch.get``          the producer thread, once per source item
  ``engine.ingest``         entry of ``TriangleCountEngine.ingest``
  ``engine.ingest_chunk``   entry of ``ingest_chunk``, before an unstaged
                            chunk is staged
  ``engine.stage_chunk``    after ``stage_chunk``'s shape checks, before the
                            upload (nothing is issued on the side stream)
  ``engine.estimate``       the device-resident query of a sharded plan; the
                            ``single`` plan has none, so it never fires here
  ``checkpoint.write``      entry of the checkpoint writer; ``torn_write``
                            also stops it between the shard write and the
                            atomic rename

``with_retries`` rides out ``FaultInjected`` only. Any other exception, a
CUDA error or a kernel that fails to build or launch among them, propagates
on its first attempt: CUDA errors are sticky, and retrying estimator state
past an error of unknown extent would replay a batch.

Validation: ``run_stream`` and ``run_signed_stream`` check every batch by
default. A batch with a self-loop, a negative (or, with ``max_vertex``,
out-of-range) vertex id, a bad ``n_valid``, a malformed shape or (signed
streams) a sign other than +1/-1 would corrupt the estimator state rather
than crash, so it is quarantined: counted, kept in a bounded
``DeadLetterBuffer`` with its source position, never ingested, and it does
not advance the RNG step. The reason strings, sites, kinds, the plan grammar
and the retry schedule are the reference's.

A copy, not an import (``repro`` imports jax). Stdlib and numpy only:
``data/prefetch.py`` and ``train/checkpoint.py`` import it lazily from
below the engine.
"""
from __future__ import annotations

import random
import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np

SITES = (
    "prefetch.get",
    "engine.ingest",
    "engine.ingest_chunk",
    "engine.stage_chunk",
    "engine.estimate",
    "checkpoint.write",
)

KINDS = ("raise", "delay", "torn_write", "duplicate")

# kinds whose effect the *caller* enacts (check() only reports them), and
# the sites where that enactment is implemented
_CALLER_ENACTED = {
    "torn_write": ("checkpoint.write",),
    "duplicate": ("prefetch.get",),
}


class FaultInjected(RuntimeError):
    """A failure raised by an installed FaultPlan (deterministic chaos)."""

    def __init__(self, site: str, shot: int):
        super().__init__(f"injected fault at {site} (call #{shot})")
        self.site = site
        self.shot = shot


@dataclass(frozen=True)
class FaultSpec:
    """One named failure: fire ``kind`` at ``site`` for calls
    [``at``, ``at + times``) of that site (0-indexed per-site call count).

    ``times > RetryPolicy.max_retries`` models a *fatal* fault (retry
    exhaustion kills the loop — the kill-point tests); ``times`` at or
    below it models a *transient* one (backoff rides through it).
    """

    site: str
    kind: str = "raise"
    at: int = 0
    times: int = 1
    delay_s: float = 0.05  # only for kind="delay"

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r}; one of {SITES}")
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; one of {KINDS}")
        if self.kind in _CALLER_ENACTED and self.site not in _CALLER_ENACTED[self.kind]:
            raise ValueError(
                f"kind {self.kind!r} is only enacted at "
                f"{_CALLER_ENACTED[self.kind]}, not {self.site!r}"
            )
        if self.times < 1:
            raise ValueError("times must be >= 1")


class FaultPlan:
    """A seeded, reproducible set of FaultSpecs with per-site call counters.

    Thread-safe: sites are checked from the prefetch producer thread and the
    main loop concurrently. ``summary()`` feeds the ``--diag-json`` artifact.
    """

    def __init__(self, specs: list[FaultSpec], seed: int = 0):
        self.specs = list(specs)
        self.seed = seed
        self.calls: dict[str, int] = {}
        self.fired: dict[str, int] = {}
        self.log: list[tuple[str, str, int]] = []  # (site, kind, call#)
        self._lock = threading.Lock()

    def check(self, site: str) -> Optional[str]:
        """Advance ``site``'s call counter; enact any matching spec.

        kind="raise" raises FaultInjected and kind="delay" sleeps here;
        "torn_write"/"duplicate" are returned for the caller to enact.
        """
        with self._lock:
            shot = self.calls.get(site, 0)
            self.calls[site] = shot + 1
            hit = None
            for s in self.specs:
                if s.site == site and s.at <= shot < s.at + s.times:
                    hit = s
                    break
            if hit is None:
                return None
            self.fired[site] = self.fired.get(site, 0) + 1
            self.log.append((site, hit.kind, shot))
        if hit.kind == "raise":
            raise FaultInjected(site, shot)
        if hit.kind == "delay":
            time.sleep(hit.delay_s)
            return None
        return hit.kind  # torn_write / duplicate: enacted by the caller

    def summary(self) -> dict:
        with self._lock:
            return {
                "seed": self.seed,
                "specs": [
                    {"site": s.site, "kind": s.kind, "at": s.at, "times": s.times}
                    for s in self.specs
                ],
                "calls": dict(self.calls),
                "fired": dict(self.fired),
                "log": [list(e) for e in self.log],
            }


_ACTIVE: Optional[FaultPlan] = None


def install_fault_plan(plan: Optional[FaultPlan]) -> Optional[FaultPlan]:
    """Install ``plan`` process-wide (None clears). Returns the previous."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, plan
    return prev


def active_fault_plan() -> Optional[FaultPlan]:
    return _ACTIVE


@contextmanager
def fault_plan(plan: Optional[FaultPlan]):
    """Scope a plan to a ``with`` block (restores the previous on exit)."""
    prev = install_fault_plan(plan)
    try:
        yield plan
    finally:
        install_fault_plan(prev)


def check_fault(site: str) -> Optional[str]:
    """The one-line hook instrumented sites call. No-op (one None check)
    when no plan is installed, so production paths pay ~nothing."""
    if _ACTIVE is None:
        return None
    return _ACTIVE.check(site)


_KIND_ALIASES = {"torn": "torn_write", "dup": "duplicate"}


def parse_fault_plan(spec: str, seed: int = 0) -> Optional[FaultPlan]:
    """Parse the CLI grammar ``site:kind@AT[xTIMES][~DELAY_S]``, comma-joined.

    Examples::

        engine.ingest:raise@3x2
        prefetch.get:raise@5,checkpoint.write:torn@1
        engine.estimate:delay@0x99~0.2
    """
    spec = spec.strip()
    if not spec:
        return None
    out = []
    for part in spec.split(","):
        try:
            site, rest = part.strip().split(":", 1)
            delay_s = 0.05
            if "~" in rest:
                rest, d = rest.split("~", 1)
                delay_s = float(d)
            kind, _, pos = rest.partition("@")
            kind = _KIND_ALIASES.get(kind, kind)
            at, times = 0, 1
            if pos:
                a, _, t = pos.partition("x")
                at = int(a)
                times = int(t) if t else 1
            out.append(FaultSpec(site, kind, at=at, times=times, delay_s=delay_s))
        except ValueError as e:
            raise ValueError(
                f"bad fault spec {part!r} (grammar: site:kind@AT[xTIMES]"
                f"[~DELAY_S]): {e}"
            ) from e
    return FaultPlan(out, seed=seed)


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry with exponential backoff + seeded jitter.

    ``retry_on`` defaults to FaultInjected only: estimator state must never
    be retried past an error of unknown blast radius (a replayed batch
    biases ``m_seen`` forever), so real exceptions propagate unless the
    caller explicitly opts classes in (e.g. ``(OSError,)`` for a network
    source).
    """

    max_retries: int = 3
    base_s: float = 0.02
    max_s: float = 2.0
    jitter: float = 0.5  # fraction of the backoff randomized
    seed: int = 0
    retry_on: tuple = (FaultInjected,)

    def backoff_s(self, attempt: int, rng: random.Random) -> float:
        base = min(self.max_s, self.base_s * (2.0**attempt))
        return base * (1.0 - self.jitter * rng.random())


def with_retries(
    policy: Optional[RetryPolicy],
    fn: Callable,
    *args,
    on_retry: Optional[Callable[[int, BaseException], None]] = None,
    **kwargs,
):
    """Call ``fn(*args, **kwargs)``; on a retryable exception back off and
    retry up to ``policy.max_retries`` times. ``policy=None`` disables
    retries entirely. ``on_retry(attempt, exc)`` is invoked before each
    sleep (the service loops count these into ``StreamReport.retries``).
    The jitter's generator is seeded at the first retry, so a call that
    does not fail pays no seeding; the backoff schedule is the reference's."""
    if policy is None:
        return fn(*args, **kwargs)
    rng = None
    for attempt in range(policy.max_retries + 1):
        try:
            return fn(*args, **kwargs)
        except policy.retry_on as e:
            if attempt >= policy.max_retries:
                raise
            if on_retry is not None:
                on_retry(attempt, e)
            if rng is None:
                rng = random.Random(policy.seed)
            time.sleep(policy.backoff_s(attempt, rng))


def validate_batch(W, n_valid=None, *, max_vertex: Optional[int] = None) -> Optional[str]:
    """Sanity-check one edge batch; return a rejection reason or None.

    Accepts ``(s, 2)`` single-tenant and ``(T, s, 2)`` multi-tenant batches
    with scalar or per-tenant ``n_valid``; only the first ``n_valid`` rows of
    each tenant's batch are checked (the rest is padding)."""
    W = np.asarray(W)
    if W.ndim not in (2, 3) or W.shape[-1] != 2:
        return f"malformed batch shape {W.shape} (want (s, 2) or (T, s, 2))"
    if not np.issubdtype(W.dtype, np.integer):
        return f"non-integer vertex ids (dtype {W.dtype})"
    Wt = W[None] if W.ndim == 2 else W
    T, s = Wt.shape[0], Wt.shape[1]
    if n_valid is None:
        nv = np.full((T,), s, dtype=np.int64)
    else:
        nv = np.broadcast_to(np.asarray(n_valid, dtype=np.int64).reshape(-1), (T,))
    for t in range(T):
        n = int(nv[t])
        if n < 0 or n > s:
            return f"n_valid={n} out of range [0, {s}]"
        rows = Wt[t, :n]
        if n and rows.min() < 0:
            return "negative vertex id"
        if n and np.any(rows[:, 0] == rows[:, 1]):
            return "self-loop edge"
        if max_vertex is not None and n and rows.max() >= max_vertex:
            return f"vertex id >= max_vertex={max_vertex}"
    return None


def validate_signed_item(item, *, max_vertex: Optional[int] = None) -> Optional[str]:
    """Validate one signed-stream item: ``(W, n_valid)`` or
    ``(W, n_valid, sign)`` with sign strictly +1/-1 (``signed_batches``
    never mixes signs within a batch)."""
    if not isinstance(item, (tuple, list)) or len(item) not in (2, 3):
        return f"malformed signed item (len {len(item) if hasattr(item, '__len__') else '?'})"
    if len(item) == 3:
        try:
            sign = int(item[2])
        except (TypeError, ValueError):
            return f"non-integer sign {item[2]!r}"
        if sign not in (1, -1):
            return f"sign {sign} not in (+1, -1) (sign mixing?)"
    return validate_batch(item[0], item[1], max_vertex=max_vertex)


class DeadLetterBuffer:
    """Bounded quarantine for rejected batches: the newest ``capacity``
    poisoned payloads are kept for inspection, with a total count that
    keeps counting after eviction."""

    def __init__(self, capacity: int = 16):
        self.capacity = capacity
        self.items: deque = deque(maxlen=max(1, capacity))
        self.total = 0

    def put(self, reason: str, position: int, payload: Any) -> None:
        self.total += 1
        self.items.append({"reason": reason, "position": position, "payload": payload})

    def reasons(self) -> list[str]:
        return [it["reason"] for it in self.items]

    def __len__(self) -> int:
        return len(self.items)


@dataclass
class ResilienceConfig:
    """What the service loops do about faults: with ``validate`` (the
    default) a poisoned batch is quarantined, ``max_vertex`` also rejects ids
    at or above it and ``dead_letter_capacity`` bounds the payloads kept;
    ``retry`` rides out transient ``FaultInjected`` (None: no retries);
    ``query_timeout_s`` bounds a sharded plan's device-resident query
    (no effect on ``single``); at a prefetch backlog of
    ``backpressure_depth`` (0: off) report queries are answered from the
    engine's estimate cache, tagged with their age."""

    retry: Optional[RetryPolicy] = field(default_factory=RetryPolicy)
    validate: bool = True
    max_vertex: Optional[int] = None
    dead_letter_capacity: int = 16
    query_timeout_s: Optional[float] = None
    backpressure_depth: int = 0
