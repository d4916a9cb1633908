"""Camera samples (pixel x sample) that reached host memory in the
window, over the window's time, in millions a second.

The mesh cell's own copy: its images spread 1.1-1.7% in rate from run
to run, more than ``msamples_per_s``'s bound holds, so it has a bound
of its own."""

from benchmark.stats import rate


def read(ctx):
    return rate(ctx.window.samples, ctx.window.seconds) / 1e6
