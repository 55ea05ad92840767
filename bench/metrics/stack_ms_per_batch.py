"""stack_ms_per_batch.<cell>: host time stacking K batches into a
superbatch (the ``service.stack`` span around ``stack_batches``), per batch
ingested."""

from bench.program_spans import host_ms_per_batch


def read(ctx):
    return host_ms_per_batch(ctx, "service.stack")
