"""Device time of every kernel of the profiled slice but the trace
kernels, and not the copies (the session's blend chain, resets and
counters), in ms a frame stepped in the slice."""


def read(ctx):
    if ctx.slice is None or not ctx.slice_counts["frames"]:
        return None
    return ctx.slice.other_kernel_s * 1e3 / ctx.slice_counts["frames"]
