"""Segments traced in the profiled slice (the session's
``segments_traced``) over the trace kernels' device time there, in
millions a second.

The orbit's own copy: that cell reports ``frame_ms_p95`` and not
``msamples_per_s``, so the same reading moves its tail."""


def read(ctx):
    if ctx.slice is None or ctx.slice.trace_kernel_s <= 0:
        return None
    return ctx.slice_counts["segs"] / ctx.slice.trace_kernel_s / 1e6
