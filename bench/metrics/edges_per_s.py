"""edges_per_s: every edge ingested in the window (all jobs, their queries
included) over the window's seconds."""
from bench import stats


def read(ctx):
    return stats.rate(ctx.window.edges, ctx.window.seconds)
