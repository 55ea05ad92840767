"""The stream service loop (``repro.engine.service.run_stream``).

Batches flow through a ``PrefetchQueue`` so host-side generation overlaps
device work. With ``chunk_size = K > 1`` the loop assembles K-batch
superbatches and double-buffers them: it dispatches the staged chunk (the
call returns once the work is queued), then stages the next one, whose upload
overlaps the dispatched chunk's compute. The ragged tail goes batch by batch.
The state is bit-identical to per-batch ingestion.

Checkpointing (``ckpt_dir``) and the resilience layer (validation,
quarantine, retries, degraded queries) come with later ROADMAP items.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Iterable, Optional

import numpy as np

from repro_torch.data.prefetch import PrefetchQueue, superbatches
from repro_torch.engine.engine import TriangleCountEngine

QueryCallback = Callable[[int, np.ndarray, np.ndarray], None]


@dataclass
class StreamReport:
    """What one ``run_stream`` call did."""

    batches: int = 0
    edges: int = 0
    seconds: float = 0.0

    @property
    def edges_per_s(self) -> float:
        return self.edges / self.seconds if self.seconds > 0 else 0.0


def run_stream(
    engine: TriangleCountEngine,
    batch_iter: Iterable,
    *,
    report_every: int = 0,
    on_report: Optional[QueryCallback] = None,
    prefetch_depth: int = 4,
) -> StreamReport:
    """Drain ``batch_iter`` ((W, n_valid) pairs) into ``engine``.
    ``on_report(step, estimates, edges_seen)`` runs every ``report_every``
    batches (at chunk granularity when chunking). The clock stops after the
    device has finished."""
    rep = StreamReport()
    pf = PrefetchQueue(iter(batch_iter), depth=prefetch_depth)
    K = engine.config.chunk_size
    t0 = time.perf_counter()

    def after_ingest(n_batches: int, n_edges: int) -> None:
        rep.batches += n_batches
        rep.edges += n_edges
        if report_every and on_report and engine.step % report_every == 0:
            on_report(engine.step, engine.estimate(), engine.edges_seen())

    if K <= 1:
        for W, nv in pf:
            engine.ingest(W, nv)
            after_ingest(1, int(nv))
    else:
        pending = None
        for kind, payload in superbatches(pf, K, engine.config.batch_size):
            if pending is not None:
                engine.ingest_chunk(pending)
                after_ingest(K, pending.edges)
                pending = None
            if kind == "chunk":
                pending = engine.stage_chunk(*payload)
            else:
                W, nv = payload
                engine.ingest(W, nv)
                after_ingest(1, int(nv))
        if pending is not None:
            engine.ingest_chunk(pending)
            after_ingest(K, pending.edges)
    engine.sync()
    rep.seconds = time.perf_counter() - t0
    return rep
