"""Host-side prefetch and superbatch assembly (``repro.data.prefetch``).

``PrefetchQueue`` keeps a bounded queue of ready batches filled by a
background thread, so host-side generation overlaps device work. The
producer touches host numpy only, never CUDA. Its resilience, as in the
reference:

  * it tags every item with a sequence number, and ``get`` drops an item
    whose number it has already handed out (``duplicate_drops``), so an
    at-least-once source still yields exactly-once ingestion;
  * it passes through the ``prefetch.get`` fault site once per source item
    (``repro_torch.engine.faults``), riding out transient raises with its
    ``RetryPolicy`` (``retries``) and enacting ``duplicate`` by enqueuing
    the item twice (``redelivered``);
  * with ``deadline_s`` a ``get`` that waits past the deadline returns the
    last batch again as a stale stand-in, at most one per late item; the
    late item is dropped when it lands (``late_drops``), and a stand-in
    whose late item turns out to be the end of the stream is counted in
    ``unmatched_standins``;
  * an exception in the producer is re-raised by ``get`` instead of looking
    like a clean end of stream;
  * ``backlog()`` is the queue's depth, the service loops' backpressure
    signal.

``TenantQueues`` holds the elastic serving tier's bounded per-tenant
queues. ``stack_batches`` / ``superbatches`` assemble K ``(W, n_valid)``
batches into the unit ``TriangleCountEngine.ingest_chunk`` consumes.
``work_stealing_shards`` merges per-file shard iterators round-robin.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Optional

import numpy as np

_DONE = object()  # the end marker, distinct from any item (even None)


class PrefetchQueue:
    """Bounded producer/consumer queue over an iterator. The producer thread
    owns ``redelivered``, ``retries``, ``done`` and ``_error``; the consumer
    (``get``) owns the dedup and staleness state. ``get`` reads ``_error``
    only after taking the end marker (the queue orders the two)."""

    def __init__(self, source: Iterator, depth: int = 4, deadline_s: Optional[float] = None,
                 retry=None):
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.deadline_s = deadline_s
        self.retry = retry  # Optional[repro_torch.engine.faults.RetryPolicy] for the source
        self.backup = None
        self.stale_steps = 0
        self.late_drops = 0  # late items dropped on arrival after a stand-in
        self.duplicate_drops = 0  # redelivered items dropped by sequence number
        self.redelivered = 0  # items the producer enqueued twice
        self.retries = 0  # transient source faults ridden out
        self.unmatched_standins = 0  # stand-ins whose late item was the end of the stream
        self.done = False
        self._last_seq = -1  # newest sequence number handed out
        self._drop_next = 0  # late items still to drop on arrival
        self._ended = False  # the end marker was taken: later calls end at once
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._produce, args=(source,), daemon=True)
        self._thread.start()

    def _produce(self, source) -> None:
        try:
            for seq, item in enumerate(source):
                kind = self._source_fault()
                self.q.put((seq, item))
                if kind == "duplicate":
                    # an at-least-once source: the same sequence number again
                    self.redelivered += 1
                    self.q.put((seq, item))
        except BaseException as e:  # noqa: BLE001 -- re-raised in get()
            self._error = e
        finally:
            self.done = True
            self.q.put(_DONE)

    def _source_fault(self):
        """The ``prefetch.get`` site, its transient raises ridden out with
        the queue's RetryPolicy."""
        # lazy: repro_torch.data sits below repro_torch.engine
        from repro_torch.engine.faults import active_fault_plan, check_fault, with_retries

        if active_fault_plan() is None:
            return None

        def count(attempt, exc):
            self.retries += 1

        return with_retries(self.retry, check_fault, "prefetch.get", on_retry=count)

    def get(self):
        """``(item, stale)``: the next item, or on a deadline miss the last
        one again with ``stale`` True. StopIteration at the end of the
        source; the producer's exception if the source raised.

        A stand-in takes the late item's place, so the late item is dropped
        when it lands; until it has, ``get`` waits without a deadline rather
        than echo the backup again, so each source item costs at most one
        stand-in and the items delivered (real and stale) equal the source's
        whenever the late item arrives."""
        while not self._ended:
            try:
                timeout = self.deadline_s if not self._drop_next else None
                entry = self.q.get(timeout=timeout)
            except queue.Empty:
                if self.backup is None:
                    entry = self.q.get()  # the first item: nothing to stand in
                else:
                    self.stale_steps += 1
                    self._drop_next += 1
                    return self.backup, True
            if entry is _DONE:
                self._ended = True
                self.unmatched_standins += self._drop_next
                self._drop_next = 0
                break
            seq, item = entry
            if seq <= self._last_seq:
                self.duplicate_drops += 1
                continue
            self._last_seq = seq
            if self._drop_next:
                self._drop_next -= 1
                self.late_drops += 1
                continue
            self.backup = item
            return item, False
        if self._error is not None:
            raise self._error
        raise StopIteration

    def __iter__(self):
        """``(item, stale)`` pairs until the end of the source."""
        while True:
            try:
                yield self.get()
            except StopIteration:
                return

    def backlog(self) -> int:
        """Entries queued ahead of the consumer (the end marker counts
        until it is taken): the service loops' backpressure signal."""
        return self.q.qsize()


class TenantQueues:
    """Bounded per-tenant ingest queues for the elastic serving tier
    (``repro_torch.engine.service.ElasticServeLoop``).

    Each resident tenant gets one FIFO capped at ``depth`` batches, so a
    stalled or flooding tenant cannot grow host memory without bound. When a
    queue is full ``put`` applies the overflow ``policy``: ``"drop"``
    discards the newest batch (the arriving one) and counts it in
    ``dropped``; ``"stall"`` refuses it (returns False) and counts the
    refusal in ``stalls``, and the producer owns the retry. The consumer
    (``take``) dequeues up to ``chunk_size`` batches per tick, oldest first,
    front-packed for the fused dispatch.

    Thread-safe: producers ``put`` while the serve loop's consumer thread
    ``take``s; every access to ``_queues``, ``dropped`` and ``stalls`` holds
    the lock. A dropped batch breaks that tenant's exactly-once stream by
    design (load shedding, visible in ``dropped``); accuracy-sensitive
    producers run ``"stall"`` and retry.
    """

    def __init__(self, depth: int = 64, policy: str = "drop"):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        if policy not in ("drop", "stall"):
            raise ValueError(f"policy must be 'drop' or 'stall', got {policy!r}")
        self.depth = depth
        self.policy = policy
        self._lock = threading.Lock()
        self.dropped = 0  # batches shed by the 'drop' policy (newest first)
        self.stalls = 0  # puts refused by the 'stall' policy (backpressure)
        self._queues: dict = {}

    def add_tenant(self, tid) -> None:
        with self._lock:
            self._queues.setdefault(tid, [])

    def remove_tenant(self, tid) -> int:
        """Drop a tenant's queue; returns how many pending batches died with
        it (they were never ingested)."""
        with self._lock:
            return len(self._queues.pop(tid, []))

    def put(self, tid, item) -> bool:
        """Enqueue one ``(W, n_valid)`` batch for ``tid``. False where the
        batch was shed (full queue under 'drop') or refused (full queue
        under 'stall', or an unknown tenant)."""
        with self._lock:
            q = self._queues.get(tid)
            if q is None:
                return False
            if len(q) >= self.depth:
                if self.policy == "drop":
                    self.dropped += 1
                else:
                    self.stalls += 1
                return False
            q.append(item)
            return True

    def take(self, tid, k: int = 1) -> list:
        """Dequeue up to ``k`` batches for ``tid``, oldest first: one
        front-packed chunk lane."""
        with self._lock:
            q = self._queues.get(tid)
            if not q:
                return []
            out, self._queues[tid] = q[:k], q[k:]
            return out

    def backlog(self, tid=None) -> int:
        """Pending batches for one tenant, or in all: the serve loop's
        backpressure signal."""
        with self._lock:
            if tid is not None:
                return len(self._queues.get(tid, ()))
            return sum(len(q) for q in self._queues.values())

    def tenants(self) -> tuple:
        with self._lock:
            return tuple(self._queues)

    def diag(self) -> dict:
        with self._lock:
            return {
                "queue_depth": self.depth,
                "queue_policy": self.policy,
                "queue_dropped": self.dropped,
                "queue_stalls": self.stalls,
                "queue_backlog": sum(len(q) for q in self._queues.values()),
            }


def stack_batches(buf: list, batch_size: Optional[int] = None) -> tuple[np.ndarray, np.ndarray]:
    """Stack K ``(W, n_valid)`` batches into ``(Ws (K, s, 2), n_valids (K,))``;
    ``batch_size`` zero-pads short batches to s first."""
    Ws, nvs = [], []
    for W, nv in buf:
        W = np.asarray(W, dtype=np.int32)
        if batch_size is not None and W.shape[-2] < batch_size:
            pad = [(0, 0)] * (W.ndim - 2) + [(0, batch_size - W.shape[-2]), (0, 0)]
            W = np.pad(W, pad)
        Ws.append(W)
        nvs.append(np.asarray(nv, dtype=np.int32))
    return np.stack(Ws, axis=-3), np.stack(nvs, axis=-1)


def superbatches(batch_iter: Iterable, k: int, batch_size: Optional[int] = None) -> Iterator:
    """Group a ``(W, n_valid)`` iterator into ``("chunk", (Ws, n_valids))``
    for each full group of k and ``("batch", (W, n_valid))`` for the ragged
    tail."""
    buf: list = []
    for item in batch_iter:
        buf.append(item)
        if len(buf) == k:
            yield "chunk", stack_batches(buf, batch_size)
            buf = []
    for item in buf:
        yield "batch", item


def work_stealing_shards(shard_fns: list[Callable[[], Iterator]]) -> Iterator:
    """Strict round-robin over per-file shard iterators, dropping a shard
    from the rotation only when it is exhausted (``StopIteration``).

    This skips on exhaustion only, not on latency: a slow shard is waited
    on every rotation (``next()`` blocks), so one straggling file gates the
    merged stream. Wrap the merged iterator in ``PrefetchQueue(deadline_s=
    ...)`` for bounded-staleness straggler tolerance; this helper only
    balances shard lengths (short shards leave the rotation early and the
    rest keep yielding)."""
    iters = [fn() for fn in shard_fns]
    live = list(range(len(iters)))
    while live:
        for i in list(live):
            try:
                yield next(iters[i])
            except StopIteration:
                live.remove(i)
