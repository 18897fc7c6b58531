"""Flash attention's share of its roofline: the least time the card could
take for the window's prefill attention (every layer of every prompt at its
own length: Q, K, V read and O written once, no scores) over the device time
of the ``flash_attention`` kernel in the trace, both of the traced window.
A prompt runs at its power-of-two bucket, so padding shows as a lower
share."""


def read(ctx):
    if ctx.trace is None:
        return None
    busy = ctx.trace.seconds_of("flash_attention_kernel")
    if busy <= 0:
        return None
    c, n = ctx.config, ctx.counts
    least = sum(n.least_time(*n.flash_call(c, s))
                for a, b, s in ctx.traced_window.admissions
                if b <= ctx.traced_window.seconds)
    return 100.0 * least * c["num_hidden_layers"] / busy
