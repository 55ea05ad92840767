"""engine_host_ms_per_batch.<cell>: host time inside the engine's ingest,
stage_chunk and ingest_chunk (enqueueing and uploads), per batch ingested."""

UPDATE_CALLS = ("ingest", "stage_chunk", "ingest_chunk")


def read(ctx):
    w = ctx.window
    if not w.batches or not w.calls:
        return None
    return 1e3 * sum(w.host_s[c] for c in UPDATE_CALLS) / w.batches
