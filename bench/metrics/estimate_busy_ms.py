"""estimate_busy_ms: device time of the operations ``engine.estimate()``
issued (the query's kernels and the answer's copy to the host), per call."""


def read(ctx):
    n = ctx.window.calls.get("estimate", 0)
    if ctx.trace is None or not n:
        return None
    busy = ctx.trace.range_device_s.get("estimate", 0.0)
    return 1e3 * busy / n if busy > 0 else None
