"""The program's own spans over a traced run's window, for the readers in
``metrics/``.

``repro_torch.spans`` records while a ``torch.profiler`` session runs, so
once a ``--trace 1`` run's window has closed it holds the spans of that
window: the service loop's, the engine's and the core's stages, each a
host interval. A program without the recorder gives none, and the readers
then return None.
"""
from __future__ import annotations

from typing import Optional


def records(ctx) -> list:
    """The window's span records, taken from the program once a run and
    kept on ``ctx`` for the other readers."""
    recs = getattr(ctx, "program_spans", None)
    if recs is None:
        try:
            from repro_torch import spans
        except ImportError:
            recs = []
        else:
            recs = [r for r in spans.take()[0] if r.end is not None]
        ctx.program_spans = recs
    return recs


def host_ms_per_batch(ctx, name: str) -> Optional[float]:
    """Host milliseconds inside the spans called ``name``, per batch the
    window ingested; None where no such span ran."""
    ns = [r.end - r.start for r in records(ctx) if r.name == name]
    batches = ctx.window.batches
    return 1e-6 * sum(ns) / batches if ns and batches else None
