"""Launch to the first timed step: the program's import and meta set-up,
the weights from the seed, the session's home and stream, the warm-up."""


def read(ctx):
    return ctx.setup_s
