"""The model FLOPs of the window's prompts (at their own lengths) over the
prefills' wall time at the card's bf16 peak, in %."""


def read(ctx):
    c, n = ctx.config, ctx.counts
    adm = [(b - a, s) for a, b, s in ctx.window.admissions if b <= ctx.seconds]
    wall = sum(w for w, _ in adm)
    if not wall:
        return None
    return 100.0 * sum(n.prefill_flops(c, s) for _, s in adm) / (wall * n.PEAK_FLOPS)
