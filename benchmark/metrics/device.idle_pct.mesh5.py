"""Share of the profiled slice in which no kernel, copy or fill ran on the
card, in %.

The mesh cell's own copy: its images spread 1.1-1.7% in rate from run
to run, more than ``msamples_per_s``'s bound holds, so it reports
``msamples_per_s.mesh5``, and the same reading moves that."""


def read(ctx):
    if ctx.slice is None or ctx.slice.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.slice.busy_s / ctx.slice.window_s)
