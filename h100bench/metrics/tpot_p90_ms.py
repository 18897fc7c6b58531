"""90th percentile of every gap between consecutive output tokens of a
request inside the window (open gaps at the window's end at their age)."""


def read(ctx):
    p = ctx.stats.percentile(ctx.stats.token_gaps(ctx.window), 90)
    return None if p is None else p * 1e3
