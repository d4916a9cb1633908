"""Device time of every kernel of the profiled slice but the trace
kernels, and not the copies (the adaptive session's folds, scores, sort
and segment sums, the bootstrap's folds included), in ms an auto round
stepped in the slice."""


def read(ctx):
    if ctx.slice is None or not ctx.slice_counts["rounds"]:
        return None
    return ctx.slice.other_kernel_s * 1e3 / ctx.slice_counts["rounds"]
