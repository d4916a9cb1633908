"""Device time of every kernel of the profiled slice but the trace
kernels, and not the copies (the session's blend chain, resets and
counters), in ms a frame stepped in the slice.

The mesh cell's own copy: its images spread 1.1-1.7% in rate from run
to run, more than ``msamples_per_s``'s bound holds, so it reports
``msamples_per_s.mesh5``, and the same reading moves that."""


def read(ctx):
    if ctx.slice is None or not ctx.slice_counts["frames"]:
        return None
    return ctx.slice.other_kernel_s * 1e3 / ctx.slice_counts["frames"]
