"""Camera samples (pixel x sample) that reached host memory in the
window, over the window's time, in millions a second."""

from benchmark.stats import rate


def read(ctx):
    return rate(ctx.window.samples, ctx.window.seconds) / 1e6
