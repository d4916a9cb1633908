"""Camera samples (pixel x sample) that reached host memory in the
window, over the window's time, in millions a second.

The adaptive cell's own copy: its rate is bound by the host's launches,
which spread from run to run more than ``msamples_per_s``'s bound holds,
so it has a bound of its own. An adaptive image's samples are its spp
map's sum."""

from benchmark.stats import rate


def read(ctx):
    return rate(ctx.window.samples, ctx.window.seconds) / 1e6
