"""Share of the profiled slice in which no kernel, copy or fill ran on the
card, in %.

The adaptive cell's own copy: that cell reports
``msamples_per_s.adaptive``, so the same reading moves its rate."""


def read(ctx):
    if ctx.slice is None or ctx.slice.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.slice.busy_s / ctx.slice.window_s)
