"""prefetch_wait_ms_per_batch.<cell>: host time the service loop waits on
the prefetch queue for its next batch (the ``service.prefetch_wait`` span),
per batch ingested."""

from bench.program_spans import host_ms_per_batch


def read(ctx):
    return host_ms_per_batch(ctx, "service.prefetch_wait")
