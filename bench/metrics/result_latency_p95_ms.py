"""result_latency_p95_ms: the 95th percentile over every answer of the
window (report queries and each job's final estimate), each timed from the
hand-off of the newest batch it covers to the service's prefetch thread to
its arrival."""
from bench import stats


def read(ctx):
    return stats.percentile(ctx.window.latencies_ms, 95)
