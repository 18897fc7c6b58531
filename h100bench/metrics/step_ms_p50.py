"""Median wall of ``ServeSession.step()`` over the window (admissions are
separate calls, so no step admits)."""


def read(ctx):
    p = ctx.stats.percentile(ctx.stats.step_walls(ctx.window), 50)
    return None if p is None else p * 1e3
