"""Device time of every kernel of the profiled slice but the trace
kernels, and not the copies (the session's blend chain, resets and
counters), in ms a frame stepped in the slice.

The orbit's own copy: that cell reports ``frame_ms_p95`` and not
``msamples_per_s``, so the same reading moves its tail."""


def read(ctx):
    if ctx.slice is None or not ctx.slice_counts["frames"]:
        return None
    return ctx.slice.other_kernel_s * 1e3 / ctx.slice_counts["frames"]
