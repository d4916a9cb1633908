"""Host time of one auto round of the adaptive session
(``AdaptiveSession.step()`` after the bootstrap: the score pass, the
selection, the launch and the fold): the mean of the benchmark's span
around each call, in ms, outside the profiled slice."""

from benchmark.stats import mean


def read(ctx):
    return mean(ctx.spans.get("step", ()))
