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

Validation: by default every batch is checked (``engine.faults``). A
poisoned batch is quarantined to a dead-letter buffer with its source
position, never ingested, and does not advance the RNG step. Superbatches
are assembled from admitted batches only, so chunk boundaries are the
reference's.

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

Signed streams (``run_signed_stream``): the same loop over ``(W, n_valid)``
and ``(W, n_valid, sign)`` items, batch by batch, with deletions applied
through ``engine.delete``. Every cursor is ``engine.dyn_step`` (signed
batches applied), because deletions advance the stream and not the RNG
step. Retries, fault sites, stale answers and deadlines come with ROADMAP
A.9.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional

import numpy as np

from repro_torch.data.prefetch import PrefetchQueue, superbatches
from repro_torch.engine.engine import SnapshotMismatch, TriangleCountEngine
from repro_torch.engine.faults import (
    DeadLetterBuffer,
    ResilienceConfig,
    validate_batch,
    validate_signed_item,
)
from repro_torch.train.checkpoint import CheckpointCorrupt, CheckpointManager, config_hash

QueryCallback = Callable[[int, np.ndarray, np.ndarray], None]


@dataclass
class StreamReport:
    """What one ``run_stream`` call did."""

    batches: int = 0  # batches ingested by this call (not the resumed ones)
    edges: int = 0  # max over tenants of the edges ingested by this call
    seconds: float = 0.0
    resumed_from: int = 0  # engine step (dyn_step, signed) restored from a checkpoint, 0 if fresh
    ckpt_corrupt_skipped: int = 0  # torn or corrupt checkpoints walked past
    quarantined_batches: int = 0  # invalid batches diverted to dead letters
    dead_letters: Optional[DeadLetterBuffer] = field(default=None, repr=False)

    @property
    def edges_per_s(self) -> float:
        return self.edges / self.seconds if self.seconds > 0 else 0.0


def _restore_latest(engine: TriangleCountEngine, ckpt_dir: Optional[str], rep: StreamReport
                    ) -> tuple[Optional[CheckpointManager], Optional[dict]]:
    """Open ``ckpt_dir`` and restore the newest checkpoint that verifies into
    ``engine``, walking back past torn or corrupt ones (counted in
    ``rep.ckpt_corrupt_skipped``). Returns (manager or None, the restored
    checkpoint's manifest or None).

    Keys the snapshot grew over time (``scheme``, then ``dyn_step``) are
    dropped from the template where the saved manifest predates them;
    ``engine.restore`` defaults both. A config mismatch is not walked past:
    restoring an older checkpoint would silently rewind the stream when the
    real problem is a wrong ``ckpt_dir``."""
    if ckpt_dir is None:
        return None, None
    ckpt = CheckpointManager(ckpt_dir, async_save=True)
    full = engine.snapshot()
    for step in reversed(ckpt.steps()):
        try:
            saved = ckpt.manifest(step)
        except CheckpointCorrupt:
            rep.ckpt_corrupt_skipped += 1
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
            rep.ckpt_corrupt_skipped += 1
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


def run_stream(
    engine: TriangleCountEngine,
    batch_iter: Iterable,
    *,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 0,
    report_every: int = 0,
    on_report: Optional[QueryCallback] = None,
    prefetch_depth: int = 4,
    resilience: Optional[ResilienceConfig] = None,
) -> StreamReport:
    """Drain ``batch_iter`` ((W, n_valid) pairs) into ``engine``.

    With ``ckpt_dir`` the engine first restores the newest checkpoint there
    that verifies and skips the consumed prefix of the iterator, then saves
    every ``ckpt_every`` batches (0: only at the end). Reports
    (``on_report(step, estimates, edges_seen)`` every ``report_every``
    batches) and checkpoints land at chunk granularity when chunking.
    ``resilience`` (default: validation on) controls the quarantine. The
    clock stops after the device has finished."""
    res = resilience if resilience is not None else ResilienceConfig()
    rep = StreamReport(dead_letters=DeadLetterBuffer(res.dead_letter_capacity))
    ckpt, manifest = _restore_latest(engine, ckpt_dir, rep)
    if manifest is not None:
        rep.resumed_from = engine.step
    pf = PrefetchQueue(iter(batch_iter), depth=prefetch_depth)
    meta = {"r": engine.config.r, "batch": engine.config.batch_size,
            "tenants": engine.config.n_tenants}
    # resume position in SOURCE items (ingested + quarantined); a checkpoint
    # without source_pos falls back to engine.step, exact when nothing was
    # quarantined
    skip = engine.step
    if manifest is not None and "source_pos" in manifest:
        skip = int(manifest["source_pos"])
    K = engine.config.chunk_size
    t0 = time.perf_counter()
    # committed: source position of the newest INGESTED batch. Batches taken
    # but still buffered (superbatch assembly, a staged chunk) are not
    # counted, so a checkpoint never skips a batch that was not ingested.
    committed = skip
    pend: deque = deque()  # source positions of admitted, not yet ingested batches

    def save() -> None:
        ckpt.save(engine.step, engine.snapshot(),
                  {"config_hash": config_hash(meta), **meta, "source_pos": committed})

    def after_ingest(n_batches: int, n_edges: int) -> None:
        nonlocal committed
        for _ in range(n_batches):
            if pend:
                committed = pend.popleft()
        rep.batches += n_batches
        rep.edges += n_edges
        if report_every and on_report and engine.step % report_every == 0:
            on_report(engine.step, engine.estimate(), engine.edges_seen())
        if ckpt and ckpt_every and rep.batches % ckpt_every == 0:
            save()

    def admitted():
        """The validated post-skip batches; each one's source position waits
        in ``pend`` until the ingest that contains it."""
        for pos, (W, nv) in enumerate(pf, start=1):
            if pos <= skip:
                continue
            if res.validate:
                reason = validate_batch(W, nv, max_vertex=res.max_vertex)
                if reason is not None:
                    rep.quarantined_batches += 1
                    rep.dead_letters.put(reason, pos, (W, nv))
                    continue
            pend.append(pos)
            yield W, nv

    if K <= 1:
        for W, nv in admitted():
            engine.ingest(W, nv)
            after_ingest(1, int(np.asarray(nv).max()))
    else:
        pending = None
        for kind, payload in superbatches(admitted(), K, engine.config.batch_size):
            if pending is not None:
                engine.ingest_chunk(pending)
                after_ingest(K, pending.edges)
                pending = None
            if kind == "chunk":
                pending = engine.stage_chunk(*payload)
            else:
                W, nv = payload
                engine.ingest(W, nv)
                after_ingest(1, int(np.asarray(nv).max()))
        if pending is not None:
            engine.ingest_chunk(pending)
            after_ingest(K, pending.edges)
    engine.sync()
    rep.seconds = time.perf_counter() - t0
    if ckpt:
        ckpt.wait()
        save()
        ckpt.wait()
    return rep


def run_signed_stream(
    engine: TriangleCountEngine,
    batch_iter: Iterable,
    *,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 0,
    report_every: int = 0,
    on_report: Optional[QueryCallback] = None,
    prefetch_depth: int = 4,
    resilience: Optional[ResilienceConfig] = None,
) -> StreamReport:
    """Drain a signed batch iterator (``graph_stream.signed_batches``) into
    ``engine``, one batch at a time: inserts through ``engine.ingest``,
    deletions (sign -1) through ``engine.delete``. Checkpoints are saved
    under ``engine.dyn_step`` every ``ckpt_every`` applied batches and at the
    end, with ``source_pos`` the source items consumed; a resume restores
    the newest one that verifies and skips that many items. Reports land
    where ``dyn_step`` is a multiple of ``report_every``. Chunked ingest does
    not apply here (deletions break insert runs anywhere); drive
    ``engine.ingest_signed_stream`` for that."""
    res = resilience if resilience is not None else ResilienceConfig()
    rep = StreamReport(dead_letters=DeadLetterBuffer(res.dead_letter_capacity))
    ckpt, manifest = _restore_latest(engine, ckpt_dir, rep)
    if manifest is not None:
        rep.resumed_from = engine.dyn_step
    pf = PrefetchQueue(iter(batch_iter), depth=prefetch_depth)
    meta = {"r": engine.config.r, "batch": engine.config.batch_size,
            "tenants": engine.config.n_tenants}
    skip = engine.dyn_step  # signed items already folded into the state
    if manifest is not None and "source_pos" in manifest:
        skip = int(manifest["source_pos"])
    t0 = time.perf_counter()
    committed = skip  # source position of the newest applied item

    def save() -> None:
        ckpt.save(engine.dyn_step, engine.snapshot(),
                  {"config_hash": config_hash(meta), **meta, "source_pos": committed})

    for pos, item in enumerate(pf, start=1):
        if pos <= skip:
            continue
        if res.validate:
            reason = validate_signed_item(item, max_vertex=res.max_vertex)
            if reason is not None:
                rep.quarantined_batches += 1
                rep.dead_letters.put(reason, pos, item)
                continue
        if len(item) > 2 and int(item[2]) < 0:
            engine.delete(item[0], item[1])
        else:
            engine.ingest(item[0], item[1])
        committed = pos
        rep.batches += 1
        rep.edges += int(np.max(np.asarray(item[1])))
        if report_every and on_report and engine.dyn_step % report_every == 0:
            on_report(engine.dyn_step, engine.estimate(), engine.edges_seen())
        if ckpt and ckpt_every and rep.batches % ckpt_every == 0:
            save()
    engine.sync()
    rep.seconds = time.perf_counter() - t0
    if ckpt:
        ckpt.wait()
        save()
        ckpt.wait()
    return rep
