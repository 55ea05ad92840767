"""update_roofline.<cell>: the least bytes a batch must move (every
tenant's s edges read once, its 21-byte estimator state read and written
once per K batches; ``stats.least_bytes_per_batch``, from the
configuration) at the card's peak bandwidth, over the device time the
update took per batch."""
from bench import stats

UPDATE_CALLS = ("ingest", "stage_chunk", "ingest_chunk")


def read(ctx):
    if ctx.trace is None or not ctx.peaks or not ctx.window.batches:
        return None
    busy = sum(ctx.trace.range_device_s.get(c, 0.0) for c in UPDATE_CALLS)
    return stats.roofline_pct(stats.least_bytes_per_batch(ctx.config),
                              busy / ctx.window.batches, ctx.peaks["hbm_bytes_per_s"])
