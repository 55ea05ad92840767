"""setup_s: process start to the first timed batch (the kernels' build on a
first run, the graphs' generation, the warm-up job)."""


def read(ctx):
    return ctx.setup_s
