"""The stream service loop (``repro.engine.service.run_stream``).

Batches flow through a ``PrefetchQueue`` so host-side generation overlaps
device work. With ``chunk_size = K > 1`` the loop assembles K-batch
superbatches and double-buffers them: it dispatches the staged chunk (the
call returns once the work is queued), then stages the next one, whose upload
overlaps the dispatched chunk's compute. The ragged tail goes batch by batch.
The state is bit-identical to per-batch ingestion. Over a bank of tenants an
item's W is ``(s, 2)`` (every tenant) or ``(T, s, 2)`` (a batch per tenant)
and its ``n_valid`` a scalar or ``(T,)``; the report's edges count the
largest of the tenants' batches, as the reference's do.

Resilience (``engine.faults``, a ``ResilienceConfig``):

  * by default every batch is validated; a poisoned batch is quarantined
    to a dead-letter buffer with its source position, never ingested, and
    does not advance the RNG step. Superbatches are assembled from admitted
    batches only, so chunk boundaries are the reference's;
  * ``ingest``, ``stage_chunk``, ``ingest_chunk`` and ``delete`` run under
    ``with_retries`` at the reference's places, so a transient
    ``FaultInjected`` is ridden out with bounded backoff (``retries``, with
    the producer's retries added at the end); retry exhaustion and every
    other exception propagate, since the last checkpoint is then the safe
    state;
  * the prefetch queue dedups redelivered items (``duplicate_batches``)
    and, with ``deadline_s``, stands the last batch in for a late one
    (``stale_batches``, and ``phantom_batches`` where the late item was the
    end of the stream);
  * report queries: when the prefetch backlog reaches
    ``backpressure_depth`` the answer comes from the engine's estimate cache,
    tagged with its age (``degraded_queries``, ``max_staleness``); a
    callback that declares a ``stale_age`` keyword receives that age, and
    ``answer_step`` is then the step the answer belongs to.

Checkpoint / resume: with ``ckpt_dir`` the engine snapshot is saved every
``ckpt_every`` ingested batches and once at the end through
``repro_torch.train.checkpoint.CheckpointManager``, with the reference's meta
{config_hash, r, batch, tenants, source_pos}. On start the loop restores the
newest checkpoint that verifies, walking back past torn or corrupt ones, and
skips the consumed prefix of the iterator: ``source_pos`` counts SOURCE
items (ingested and quarantined) up to the newest ingested batch, so a
batch that was staged but not yet ingested is never skipped. The skip counts
whole batches, so resuming under another ``batch_size`` is refused.
Checkpoint directories are interchangeable with the JAX package's.

Elastic serving (``ElasticServeLoop``): one consumer thread owns an
``ElasticBankEngine`` and drains bounded per-tenant queues
(``TenantQueues``) into it, one banked dispatch a tick, while queries and
tenancy operations (hot-add, evict, per-tenant snapshot and restore)
arrive as futures and are answered between dispatches. ``ServeStats``
counts what it did.

Signed streams (``run_signed_stream``): the same loop over ``(W, n_valid)``
and ``(W, n_valid, sign)`` items, batch by batch, with deletions applied
through ``engine.delete``. Every cursor is ``engine.dyn_step`` (signed
batches applied), because deletions advance the stream and not the RNG
step. Its resilience is ``run_stream``'s.
"""
from __future__ import annotations

import concurrent.futures
import inspect
import queue as queue_mod
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional

import numpy as np

from repro_torch.data.prefetch import PrefetchQueue, TenantQueues, superbatches
from repro_torch.engine.engine import SnapshotMismatch, TriangleCountEngine
from repro_torch.engine.faults import (
    DeadLetterBuffer,
    ResilienceConfig,
    validate_batch,
    validate_signed_item,
    with_retries,
)
from repro_torch.train.checkpoint import CheckpointCorrupt, CheckpointManager, config_hash

QueryCallback = Callable[[int, np.ndarray, np.ndarray], None]
# (answer_step, per-tenant estimates, per-tenant edges_seen) -> None; a
# callback that also declares a ``stale_age`` keyword receives 0 for a fresh
# answer and the answer's age in batches for one served from the cache


@dataclass
class StreamReport:
    """What one ``run_stream`` call did (the reference's fields, and
    ``ckpt_corrupt_skipped``, which the engine's diag counts too)."""

    batches: int = 0  # batches ingested by this call (not the resumed ones)
    edges: int = 0  # max over tenants of the edges ingested by this call
    seconds: float = 0.0
    resumed_from: int = 0  # engine step (dyn_step, signed) restored from a checkpoint, 0 if fresh
    stale_batches: int = 0  # stand-ins for batches late past the deadline
    phantom_batches: int = 0  # stand-ins whose late batch was the end of the stream
    queries: int = 0  # report queries answered mid-stream
    retries: int = 0  # attempts retried after transient faults (loop and producer)
    ckpt_corrupt_skipped: int = 0  # torn or corrupt checkpoints walked past
    quarantined_batches: int = 0  # invalid batches diverted to dead letters
    duplicate_batches: int = 0  # redelivered batches dropped by sequence number
    degraded_queries: int = 0  # report queries answered from the stale cache
    max_staleness: int = 0  # the oldest stale answer's age, in batches
    query_fallbacks: int = 0  # device queries that fell back to the gather oracle
    dead_letters: Optional[DeadLetterBuffer] = field(default=None, repr=False)

    @property
    def edges_per_s(self) -> float:
        return self.edges / self.seconds if self.seconds > 0 else 0.0


def _restore_latest(engine: TriangleCountEngine, ckpt_dir: Optional[str], rep: StreamReport
                    ) -> tuple[Optional[CheckpointManager], Optional[dict]]:
    """Open ``ckpt_dir`` and restore the newest checkpoint that verifies into
    ``engine``, walking back past torn or corrupt ones (counted in
    ``rep.ckpt_corrupt_skipped`` and, as the reference counts them, in
    ``engine.diag.ckpt_corrupt_skipped``). Returns (manager or None, the
    restored checkpoint's manifest or None).

    Keys the snapshot grew over time (``scheme``, then ``dyn_step``) are
    dropped from the template where the saved manifest predates them;
    ``engine.restore`` defaults both. A config mismatch is not walked past:
    restoring an older checkpoint would silently rewind the stream when the
    real problem is a wrong ``ckpt_dir``."""
    if ckpt_dir is None:
        return None, None
    ckpt = CheckpointManager(ckpt_dir, async_save=True)
    full = engine.snapshot()

    def skipped() -> None:
        rep.ckpt_corrupt_skipped += 1
        engine.diag.ckpt_corrupt_skipped += 1

    for step in reversed(ckpt.steps()):
        try:
            saved = ckpt.manifest(step)
        except CheckpointCorrupt:
            skipped()
            continue
        template = dict(full)
        if saved is not None and "keys" in saved:
            names = set(saved["keys"])
            for optional in ("scheme", "dyn_step"):
                if optional not in names and f"[{optional!r}]" not in names:
                    template.pop(optional, None)
        try:
            restored, manifest = ckpt.restore(template, step=step)
        except CheckpointCorrupt:
            # torn or bit-flipped: walk back to the previous one, never restore it
            skipped()
            continue
        except (KeyError, ValueError) as e:
            raise SnapshotMismatch(
                f"checkpoint in {ckpt_dir!r} does not fit this engine "
                f"(r={engine.config.r}, tenants={engine.config.n_tenants}); "
                "point ckpt_dir at a fresh directory or match the saved "
                f"config. Underlying error: {e}") from e
        ckpt_bs = int(np.asarray(restored["config"])[1])
        if ckpt_bs != engine.config.batch_size:
            raise SnapshotMismatch(
                f"checkpoint in {ckpt_dir!r} was written with batch_size={ckpt_bs}, "
                f"engine has {engine.config.batch_size}; the stream loop resumes "
                "by skipping whole batches, so the sizes must match")
        engine.restore(restored)
        return ckpt, manifest
    return ckpt, None


def _wants_stale_age(cb: Optional[QueryCallback]) -> bool:
    if cb is None:
        return False
    try:
        return "stale_age" in inspect.signature(cb).parameters
    except (TypeError, ValueError):  # builtins and C callables
        return False


def _answer_query(engine: TriangleCountEngine, pf: PrefetchQueue, res: ResilienceConfig,
                  rep: StreamReport, position: int) -> tuple[int, np.ndarray, int]:
    """One report query: ``(answer_step, estimates, stale_age)``. At a
    prefetch backlog of ``res.backpressure_depth`` the answer comes from the
    engine's cache, stale and tagged with its age in batches, so the query
    takes no device time from an ingest that is already behind; otherwise
    it is a fresh ``engine.estimate``."""
    if res.backpressure_depth and pf.backlog() >= res.backpressure_depth:
        cached = engine.cached_estimate()
        if cached is not None:
            astep, ests = cached
            age = engine.step - astep
            if age > 0:
                rep.degraded_queries += 1
                rep.max_staleness = max(rep.max_staleness, age)
                return astep, ests, age
            return position, ests, 0  # the cache is current: a plain hit
    return position, engine.estimate(timeout_s=res.query_timeout_s), 0


class _Loop:
    """What ``run_stream`` and ``run_signed_stream`` share: the resume, the
    prefetch queue, the retry counter, reports, checkpoints and the closing
    accounting. ``cursor`` names the engine's position property (``step``
    or ``dyn_step``)."""

    def __init__(self, engine, batch_iter, res, *, ckpt_dir, ckpt_every, report_every,
                 on_report, prefetch_depth, deadline_s, cursor):
        self.engine, self.res, self.cursor = engine, res, cursor
        self.ckpt_every, self.report_every, self.on_report = ckpt_every, report_every, on_report
        self.rep = StreamReport(dead_letters=DeadLetterBuffer(res.dead_letter_capacity))
        self.ckpt, manifest = _restore_latest(engine, ckpt_dir, self.rep)
        if manifest is not None:
            self.rep.resumed_from = self.position()
        self.pf = PrefetchQueue(iter(batch_iter), depth=prefetch_depth, deadline_s=deadline_s,
                                retry=res.retry)
        self.meta = {"r": engine.config.r, "batch": engine.config.batch_size,
                     "tenants": engine.config.n_tenants}
        # resume position in SOURCE items (ingested + quarantined); a
        # checkpoint without source_pos falls back to the cursor, exact when
        # nothing was quarantined
        self.skip = self.position()
        if manifest is not None and "source_pos" in manifest:
            self.skip = int(manifest["source_pos"])
        self.committed = self.skip  # source position of the newest ingested batch
        self.fallbacks0 = engine.diag.query_fallbacks
        self.wants_age = _wants_stale_age(on_report)
        self.t0 = time.perf_counter()

    def position(self) -> int:
        return getattr(self.engine, self.cursor)

    def count_retry(self, attempt, exc) -> None:
        self.rep.retries += 1

    def call(self, fn, *args):
        """``fn(*args)`` under the configured retries."""
        return with_retries(self.res.retry, fn, *args, on_retry=self.count_retry)

    def items(self):
        """``(source position, item)`` pairs past the resume point."""
        seen = 0
        while True:
            try:
                item, stale = self.pf.get()
            except StopIteration:
                return
            self.rep.stale_batches += int(stale)
            seen += 1
            if seen > self.skip:
                yield seen, item

    def quarantine(self, reason: Optional[str], pos: int, payload) -> bool:
        """Quarantine the item where ``reason`` is not None; True if it was."""
        if reason is None:
            return False
        self.rep.quarantined_batches += 1
        self.rep.dead_letters.put(reason, pos, payload)
        return True

    def after(self, n_batches: int, n_edges: int) -> None:
        """Accounting, the report query and the periodic checkpoint after an
        ingest of ``n_batches`` batches."""
        rep = self.rep
        rep.batches += n_batches
        rep.edges += n_edges
        pos = self.position()
        if self.report_every and self.on_report and pos % self.report_every == 0:
            astep, ests, age = _answer_query(self.engine, self.pf, self.res, rep, pos)
            if self.wants_age:
                self.on_report(astep, ests, self.engine.edges_seen(), stale_age=age)
            else:
                self.on_report(astep, ests, self.engine.edges_seen())
            rep.queries += 1
        if self.ckpt and self.ckpt_every and rep.batches % self.ckpt_every == 0:
            self.save()

    def save(self) -> None:
        self.ckpt.save(self.position(), self.engine.snapshot(),
                       {"config_hash": config_hash(self.meta), **self.meta,
                        "source_pos": self.committed})

    def finish(self) -> StreamReport:
        rep, pf = self.rep, self.pf
        self.engine.sync()
        rep.seconds = time.perf_counter() - self.t0
        rep.phantom_batches = pf.unmatched_standins
        rep.duplicate_batches = pf.duplicate_drops
        rep.retries += pf.retries
        rep.query_fallbacks = self.engine.diag.query_fallbacks - self.fallbacks0
        if self.ckpt:
            self.ckpt.wait()
            self.save()
            self.ckpt.wait()
        return rep


def run_stream(
    engine: TriangleCountEngine,
    batch_iter: Iterable,
    *,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 0,
    report_every: int = 0,
    on_report: Optional[QueryCallback] = None,
    prefetch_depth: int = 4,
    deadline_s: Optional[float] = None,
    resilience: Optional[ResilienceConfig] = None,
) -> StreamReport:
    """Drain ``batch_iter`` ((W, n_valid) pairs) into ``engine``.

    With ``ckpt_dir`` the engine first restores the newest checkpoint there
    that verifies and skips the consumed prefix of the iterator, then saves
    every ``ckpt_every`` batches (0: only at the end). Reports
    (``on_report(step, estimates, edges_seen)`` every ``report_every``
    batches) and checkpoints land at chunk granularity when chunking.
    ``deadline_s`` (default: none, since an estimator stream must not echo
    batches unless asked to) lets a late batch be stood in for by the last
    one. ``resilience`` (default: validation on, ``FaultInjected``-only
    retries, no backpressure) controls quarantine, retries and stale
    answers. The clock stops after the device has finished."""
    res = resilience if resilience is not None else ResilienceConfig()
    loop = _Loop(engine, batch_iter, res, ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
                 report_every=report_every, on_report=on_report,
                 prefetch_depth=prefetch_depth, deadline_s=deadline_s, cursor="step")
    K = engine.config.chunk_size
    # positions of admitted batches not yet ingested: a batch taken but still
    # buffered (superbatch assembly, a staged chunk) is not committed, so a
    # checkpoint never skips a batch that was not ingested
    pend: deque = deque()

    def after_ingest(n_batches: int, n_edges: int) -> None:
        for _ in range(n_batches):
            if pend:
                loop.committed = pend.popleft()
        loop.after(n_batches, n_edges)

    def admitted():
        for pos, (W, nv) in loop.items():
            if res.validate and loop.quarantine(
                    validate_batch(W, nv, max_vertex=res.max_vertex), pos, (W, nv)):
                continue
            pend.append(pos)
            yield W, nv

    if K <= 1:
        for W, nv in admitted():
            loop.call(engine.ingest, W, nv)
            after_ingest(1, int(np.asarray(nv).max()))
    else:
        # dispatch the staged chunk, then stage the next one: its upload
        # overlaps the dispatched chunk's compute
        pending = None
        for kind, payload in superbatches(admitted(), K, engine.config.batch_size):
            if pending is not None:
                loop.call(engine.ingest_chunk, pending)
                after_ingest(K, pending.edges)
                pending = None
            if kind == "chunk":
                pending = loop.call(engine.stage_chunk, *payload)
            else:  # the ragged tail, batch by batch
                W, nv = payload
                loop.call(engine.ingest, W, nv)
                after_ingest(1, int(np.asarray(nv).max()))
        if pending is not None:
            loop.call(engine.ingest_chunk, pending)
            after_ingest(K, pending.edges)
    return loop.finish()


def run_signed_stream(
    engine: TriangleCountEngine,
    batch_iter: Iterable,
    *,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 0,
    report_every: int = 0,
    on_report: Optional[QueryCallback] = None,
    prefetch_depth: int = 4,
    deadline_s: Optional[float] = None,
    resilience: Optional[ResilienceConfig] = None,
) -> StreamReport:
    """Drain a signed batch iterator (``graph_stream.signed_batches``) into
    ``engine``, one batch at a time: inserts through ``engine.ingest``,
    deletions (sign -1) through ``engine.delete``, each under the retries.
    Checkpoints are saved under ``engine.dyn_step`` every ``ckpt_every``
    applied batches and at the end, with ``source_pos`` the source items
    consumed; a resume restores the newest one that verifies and skips that
    many items. Reports land where ``dyn_step`` is a multiple of
    ``report_every``. Chunked ingest does not apply here (deletions break
    insert runs anywhere); drive ``engine.ingest_signed_stream`` for
    that."""
    res = resilience if resilience is not None else ResilienceConfig()
    loop = _Loop(engine, batch_iter, res, ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
                 report_every=report_every, on_report=on_report,
                 prefetch_depth=prefetch_depth, deadline_s=deadline_s, cursor="dyn_step")
    for pos, item in loop.items():
        if res.validate and loop.quarantine(
                validate_signed_item(item, max_vertex=res.max_vertex), pos, item):
            continue
        if len(item) > 2 and int(item[2]) < 0:
            loop.call(engine.delete, item[0], item[1])
        else:
            loop.call(engine.ingest, item[0], item[1])
        loop.committed = pos
        loop.after(1, int(np.max(np.asarray(item[1]))))
    return loop.finish()


# ---------------------------------------------------------------------------
# elastic serving: concurrent ingest and queries over a slab-allocated bank
# ---------------------------------------------------------------------------
@dataclass
class ServeStats:
    """Host-side accounting for one ElasticServeLoop run (the reference's
    fields)."""

    ticks: int = 0  # consumer-loop iterations that did work
    ingest_dispatches: int = 0  # banked dispatches (one per tick with work)
    batches: int = 0  # per-tenant batches folded into those dispatches
    queries_answered: int = 0
    degraded_queries: int = 0  # answered from the stale cache under backpressure
    max_staleness: int = 0  # the worst stale answer's age, in bank versions
    retries: int = 0  # ingest dispatches retried after transient faults
    control_ops: int = 0  # add/evict/snapshot/restore operations applied
    evicted_pending: int = 0  # queued batches that died with an evicted tenant


class ElasticServeLoop:
    """The elastic serving tier: one consumer thread drains bounded
    per-tenant queues into an ``ElasticBankEngine`` while queries and
    tenancy operations are answered between dispatches. A dispatch returns
    once its work is queued on the device, so the answers overlap the
    compute in flight.

    Producers are thread-safe and never wait on the device: ``submit`` puts
    a batch on that tenant's bounded queue (``TenantQueues``: a full queue
    sheds or stalls per its policy, counted); ``query``, ``add_tenant``,
    ``evict_tenant``, ``snapshot_tenant`` and ``restore_tenant`` return
    ``concurrent.futures.Future``s that the consumer resolves. Each tick
    the loop (1) applies queued tenancy operations, (2) assembles one
    front-packed banked batch, up to ``chunk_size`` queued batches per
    tenant, and dispatches it (transient faults at the ``engine.ingest`` and
    ``engine.ingest_chunk`` sites ridden out by ``ResilienceConfig.retry``),
    then (3) answers every waiting query from the version-keyed estimate
    cache or a fresh query. When the queues' total backlog reaches
    ``resilience.backpressure_depth`` a query is answered from the newest
    cached answer, tagged with its staleness, as ``run_stream``'s reports
    are.

    Snapshots under live traffic are exact: the consumer serialises the
    slot read against the dispatches, so ``snapshot_tenant`` sees a batch
    boundary of that tenant's stream while its neighbours keep ingesting.
    With a ``checkpoint`` manager, snapshots save through its verified
    (atomic manifest and checksum) store, and ``restore_tenant(tid,
    step=..)`` restores only what verifies. The consumer thread alone
    touches ``bank`` and ``stats``; the queues and events are the channels.
    """

    def __init__(
        self,
        bank,
        *,
        queues: Optional[TenantQueues] = None,
        queue_depth: int = 64,
        queue_policy: str = "drop",
        resilience: Optional[ResilienceConfig] = None,
        checkpoint=None,  # CheckpointManager, a directory, or None
        idle_wait_s: float = 0.005,
    ):
        self.bank = bank
        self.queues = queues if queues is not None else TenantQueues(depth=queue_depth,
                                                                     policy=queue_policy)
        self.res = resilience if resilience is not None else ResilienceConfig()
        if isinstance(checkpoint, str):
            checkpoint = CheckpointManager(checkpoint, async_save=True)
        self.ckpt: Optional[CheckpointManager] = checkpoint
        self.stats = ServeStats()
        self._idle_wait_s = idle_wait_s
        self._control: queue_mod.SimpleQueue = queue_mod.SimpleQueue()
        self._queries: queue_mod.SimpleQueue = queue_mod.SimpleQueue()
        self._work = threading.Event()
        self._stop = threading.Event()
        self._idle = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- producer-facing API (thread-safe) ----------------------------------
    def submit(self, tid, W, n_valid=None) -> bool:
        """Enqueue one batch for ``tid``. False: shed or refused (a full
        queue under its policy, or a tenant that is not resident)."""
        ok = self.queues.put(tid, (np.asarray(W, np.int32), n_valid))
        if ok:
            self._kick()
        return ok

    def query(self, tid) -> concurrent.futures.Future:
        """The tenant's estimate, later: a dict ``{tenant, estimate,
        version, stale_age}``; ``stale_age > 0`` marks a cached answer
        served under ingest backpressure."""
        fut: concurrent.futures.Future = concurrent.futures.Future()
        self._queries.put((tid, fut))
        self._kick()
        return fut

    def add_tenant(self, tid, seed=None) -> concurrent.futures.Future:
        return self._control_op(("add", tid, seed))

    def evict_tenant(self, tid) -> concurrent.futures.Future:
        return self._control_op(("evict", tid, None))

    def snapshot_tenant(self, tid, save: bool = False) -> concurrent.futures.Future:
        """The tenant's snapshot dict, later; ``save=True`` also writes it
        through the attached CheckpointManager under the tenant's step."""
        return self._control_op(("snapshot", tid, save))

    def restore_tenant(self, tid, snap=None, step=None) -> concurrent.futures.Future:
        """Restore ``tid`` from a snapshot dict, or (``step=``) from the
        attached CheckpointManager, which loads only a snapshot that
        verifies."""
        if snap is None and step is None:
            raise ValueError("restore_tenant needs snap= or step=")
        return self._control_op(("restore", tid, (snap, step)))

    def _control_op(self, op) -> concurrent.futures.Future:
        fut: concurrent.futures.Future = concurrent.futures.Future()
        self._control.put((op, fut))
        self._kick()
        return fut

    def _kick(self) -> None:
        self._idle.clear()
        self._work.set()

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "ElasticServeLoop":
        if self._thread is not None:
            raise RuntimeError("serve loop already started")
        self._thread = threading.Thread(target=self._run, name="elastic-serve", daemon=True)
        self._thread.start()
        return self

    def stop(self, drain: bool = True) -> ServeStats:
        """Stop the consumer thread; ``drain=True`` (the default) first
        finishes every queued batch, query and tenancy operation."""
        if drain:
            self.drain()
        self._stop.set()
        self._work.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.ckpt is not None:
            self.ckpt.wait()
        return self.stats

    def drain(self, timeout_s: Optional[float] = None) -> bool:
        """Block until the queues, queries and tenancy operations are all
        consumed and the bank's work has finished on the device. True on
        success, False on timeout."""
        deadline = None if timeout_s is None else time.time() + timeout_s
        while True:
            if self._idle.wait(timeout=0.05):
                self.bank.sync()
                return True
            if deadline is not None and time.time() > deadline:
                return False

    def __enter__(self) -> "ElasticServeLoop":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop(drain=exc == (None, None, None))

    def report(self) -> dict:
        """Serve stats, the bank's counters and the queues' counters, merged."""
        out = {k: getattr(self.stats, k) for k in vars(self.stats)}
        out.update(self.bank.diag.as_dict())
        out.update(self.queues.diag())
        return out

    # -- consumer thread ----------------------------------------------------
    def _run(self) -> None:
        while True:
            did = self._apply_control()
            did = self._dispatch_ingest() or did
            # answered while the dispatch above still computes on the device
            did = self._answer_queries() or did
            if did:
                self.stats.ticks += 1
                continue
            if self.queues.backlog() == 0 and self._control.empty() and self._queries.empty():
                self._idle.set()
                if self._stop.is_set():
                    return
                self._work.wait(timeout=self._idle_wait_s)
                self._work.clear()

    def _apply_control(self) -> bool:
        did = False
        while True:
            try:
                op, fut = self._control.get_nowait()
            except queue_mod.Empty:
                return did
            if not fut.set_running_or_notify_cancel():
                continue
            kind, tid, arg = op
            try:
                if kind == "add":
                    slot = self.bank.hot_add(tid, seed=arg)
                    self.queues.add_tenant(tid)
                    fut.set_result(slot)
                elif kind == "evict":
                    lost = self.queues.remove_tenant(tid)
                    self.stats.evicted_pending += lost
                    self.bank.evict(tid)
                    fut.set_result(lost)
                elif kind == "snapshot":
                    snap = self.bank.snapshot_tenant(tid)
                    if arg and self.ckpt is not None:
                        meta = {"r": self.bank.r, "batch": self.bank.batch_size,
                                "tenants": 1, "tenant_id": str(tid)}
                        self.ckpt.save(int(snap["step"]), snap,
                                       {"config_hash": config_hash(meta), **meta})
                    fut.set_result(snap)
                elif kind == "restore":
                    snap, step = arg
                    if snap is None:
                        if self.ckpt is None:
                            raise ValueError("restore by step needs a checkpoint manager")
                        # an async save of this very step may still be in
                        # flight: land it before reading the store
                        self.ckpt.wait()
                        snap, _ = self.ckpt.restore(self.bank.snapshot_template(), step=step)
                    slot = self.bank.restore_tenant(tid, snap)
                    self.queues.add_tenant(tid)
                    fut.set_result(slot)
                else:  # pragma: no cover - internal
                    raise ValueError(f"unknown control op {kind!r}")
                self.stats.control_ops += 1
            except Exception as e:  # noqa: BLE001 -- delivered to the caller
                fut.set_exception(e)
            did = True

    def _dispatch_ingest(self) -> bool:
        K = self.bank.chunk_size
        work = {}
        n_batches = 0
        for tid in self.bank.tenants():
            items = self.queues.take(tid, K if K > 1 else 1)
            if items:
                work[tid] = items
                n_batches += len(items)
        if not work:
            return False

        def count_retry(attempt, exc):
            self.stats.retries += 1

        if K > 1:
            with_retries(self.res.retry, self.bank.ingest_chunk, work, on_retry=count_retry)
        else:
            with_retries(self.res.retry, self.bank.ingest,
                         {tid: items[0] for tid, items in work.items()}, on_retry=count_retry)
        self.stats.ingest_dispatches += 1
        self.stats.batches += n_batches
        return True

    def _answer_queries(self) -> bool:
        did = False
        while True:
            try:
                tid, fut = self._queries.get_nowait()
            except queue_mod.Empty:
                return did
            if not fut.set_running_or_notify_cancel():
                continue
            try:
                fut.set_result(self._answer_one(tid))
                self.stats.queries_answered += 1
            except Exception as e:  # noqa: BLE001 -- delivered to the caller
                fut.set_exception(e)
            did = True

    def _answer_one(self, tid) -> dict:
        bank = self.bank
        depth = self.res.backpressure_depth
        if depth and self.queues.backlog() >= depth:
            cached = bank.cached_estimate()
            if cached is not None:
                v, ests = cached
                age = bank.version - v
                if age > 0:
                    self.stats.degraded_queries += 1
                    self.stats.max_staleness = max(self.stats.max_staleness, age)
                e = ests[bank.slot_of(tid)]
                return {"tenant": tid, "estimate": float(e) if np.ndim(e) == 0 else e,
                        "version": v, "stale_age": age}
        return {"tenant": tid, "estimate": bank.estimate_tenant(tid), "version": bank.version,
                "stale_age": 0}
