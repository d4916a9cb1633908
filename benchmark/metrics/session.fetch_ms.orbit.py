"""Host time of ``fetch_framebuffer()`` read to host memory: the mean of
the benchmark's span around each fetch, in ms, outside the profiled
slice."""

from benchmark.stats import mean


def read(ctx):
    return mean(ctx.spans.get("fetch", ()))
