"""Median wall of an admission's prefill (``submit`` + ``admit_pending``,
synchronized) inside the window."""


def read(ctx):
    p = ctx.stats.percentile(ctx.stats.prefill_walls(ctx.window), 50)
    return None if p is None else p * 1e3
