"""Batch validation and quarantine for the service loop
(``repro.engine.faults``, validation part).

``run_stream`` and ``run_signed_stream`` validate every batch by default.
A batch with a self-loop, a negative (or, with ``max_vertex``,
out-of-range) vertex id, a bad ``n_valid``, a malformed shape or (signed
streams) a sign other than +1/-1 would corrupt the estimator state rather
than crash, so it is quarantined: counted, kept in a bounded
``DeadLetterBuffer`` with its source position, never ingested, and it does
not advance the RNG step. The reason strings are the reference's.

A copy, not an import: ``repro`` imports jax. Retries, fault plans, query
timeouts and backpressure are the rest of the reference's resilience layer
and come with ROADMAP A.9.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np


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
    """What ``run_stream`` does with a poisoned batch: with ``validate``
    (the default) it is quarantined; ``max_vertex`` also rejects ids at or
    above it; ``dead_letter_capacity`` bounds the payloads kept."""

    validate: bool = True
    max_vertex: Optional[int] = None
    dead_letter_capacity: int = 16
