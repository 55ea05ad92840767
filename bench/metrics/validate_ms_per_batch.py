"""validate_ms_per_batch.<cell>: host time in the service's batch
validation (the ``service.validate`` span around ``validate_batch``), per
batch ingested."""

from bench.program_spans import host_ms_per_batch


def read(ctx):
    return host_ms_per_batch(ctx, "service.validate")
