"""Host time of ``RenderSession.step()`` (render/session.py): the mean of
the benchmark's span around each call, in ms, outside the profiled
slice."""

from benchmark.stats import mean


def read(ctx):
    return mean(ctx.spans.get("step", ()))
