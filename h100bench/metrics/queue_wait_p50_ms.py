"""Median time from a request's due time to the start of its prefill, over
the requests admitted inside the window."""


def read(ctx):
    p = ctx.stats.percentile(ctx.stats.queue_waits(ctx.window), 50)
    return None if p is None else p * 1e3
