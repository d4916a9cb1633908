"""Segments traced in the profiled slice (the session's
``segments_traced``) over the trace kernels' device time there, in
millions a second.

The adaptive cell's own copy: that cell reports
``msamples_per_s.adaptive``, so the same reading moves its rate."""


def read(ctx):
    if ctx.slice is None or ctx.slice.trace_kernel_s <= 0:
        return None
    return ctx.slice_counts["segs"] / ctx.slice.trace_kernel_s / 1e6
