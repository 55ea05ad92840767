"""service_host_ms_per_batch.<cell>: run_stream's host time outside the
engine's wrapped calls (validation, superbatch stacking, accounting, the
prefetch hand-off), per batch ingested."""


def read(ctx):
    w = ctx.window
    return 1e3 * w.service_s / w.batches if w.batches and w.calls else None
