"""estimate_ms: the host time inside ``engine.estimate()`` (the reports and
each job's final answer, the wait for work in flight included), per call."""


def read(ctx):
    w = ctx.window
    n = w.calls.get("estimate", 0)
    return 1e3 * w.host_s["estimate"] / n if n else None
