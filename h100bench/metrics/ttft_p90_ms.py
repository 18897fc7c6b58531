"""90th percentile, over every request due inside the window, of the time
from when it was due to its first token (a request not served by the
window's end counts at its age then)."""


def read(ctx):
    p = ctx.stats.percentile(ctx.stats.ttfts(ctx.window), 90)
    return None if p is None else p * 1e3
