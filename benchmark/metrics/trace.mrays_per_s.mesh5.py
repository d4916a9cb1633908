"""Segments traced in the profiled slice (the session's
``segments_traced``) over the trace kernels' device time there, in
millions a second.

The mesh cell's own copy: its images spread 1.1-1.7% in rate from run
to run, more than ``msamples_per_s``'s bound holds, so it reports
``msamples_per_s.mesh5``, and the same reading moves that."""


def read(ctx):
    if ctx.slice is None or ctx.slice.trace_kernel_s <= 0:
        return None
    return ctx.slice_counts["segs"] / ctx.slice.trace_kernel_s / 1e6
