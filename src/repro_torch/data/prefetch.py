"""Host-side prefetch and superbatch assembly (``repro.data.prefetch``).

``PrefetchQueue`` keeps a bounded queue of ready batches filled by a
background thread, so host-side generation overlaps device work. An
exception in the producer is re-raised in the consumer instead of looking
like a clean end of stream. (The reference's straggler deadline, fault site
and redelivery dedup belong to the resilience layer, which this port does
not carry yet.)

``stack_batches`` / ``superbatches`` assemble K ``(W, n_valid)`` batches into
the unit ``TriangleCountEngine.ingest_chunk`` consumes.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, Optional

import numpy as np

_DONE = object()


class PrefetchQueue:
    """Bounded producer/consumer queue over an iterator. The producer thread
    owns ``_error`` until it puts the end marker; ``get`` reads it only after
    taking that marker (the queue orders the two)."""

    def __init__(self, source: Iterator, depth: int = 4):
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._produce, args=(source,), daemon=True)
        self._thread.start()

    def _produce(self, source) -> None:
        try:
            for item in source:
                self.q.put(item)
        except BaseException as e:  # noqa: BLE001 -- re-raised in get()
            self._error = e
        finally:
            self.q.put(_DONE)

    def get(self):
        """The next item; StopIteration at the end of the source, or the
        producer's exception if the source raised."""
        item = self.q.get()
        if item is _DONE:
            self.q.put(_DONE)  # later calls see the end too
            if self._error is not None:
                raise self._error
            raise StopIteration
        return item

    def __iter__(self):
        while True:
            try:
                yield self.get()
            except StopIteration:
                return


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
