"""update_busy_ms_per_batch.<cell>: device time of the operations issued
inside the engine's ingest, stage_chunk and ingest_chunk, per batch, from
the profiler's trace."""

UPDATE_CALLS = ("ingest", "stage_chunk", "ingest_chunk")


def read(ctx):
    if ctx.trace is None or not ctx.window.batches:
        return None
    busy = sum(ctx.trace.range_device_s.get(c, 0.0) for c in UPDATE_CALLS)
    return 1e3 * busy / ctx.window.batches if busy > 0 else None
