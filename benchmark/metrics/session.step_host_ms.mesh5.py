"""Host time of ``RenderSession.step()`` (render/session.py): the mean of
the benchmark's span around each call, in ms, outside the profiled
slice.

The mesh cell's own copy: its images spread 1.1-1.7% in rate from run
to run, more than ``msamples_per_s``'s bound holds, so it reports
``msamples_per_s.mesh5``, and the same reading moves that."""

from benchmark.stats import mean


def read(ctx):
    return mean(ctx.spans.get("step", ()))
