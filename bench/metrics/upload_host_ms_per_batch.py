"""upload_host_ms_per_batch.<cell>: host time in the engine's uploads (the
``engine.upload`` span: the pinned buffer, the host copy into it, the
asynchronous copy's issue), per batch ingested."""

from bench.program_spans import host_ms_per_batch


def read(ctx):
    return host_ms_per_batch(ctx, "engine.upload")
