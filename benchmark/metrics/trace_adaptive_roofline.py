"""The adaptive trace kernel's share of its roofline in the profiled
slice: the bound (``benchmark/roofline.py:adaptive_bound_s``: the gated
sweep's tests a segment on the reference's pixels, scaled to the slice's
segments; the tables once a launch and each window's block sums) over the
trace kernels' device time, in %."""

from benchmark import roofline


def read(ctx):
    if ctx.slice is None or ctx.slice.trace_kernel_s <= 0 or ctx.tests_per_segment is None:
        return None
    c, a = ctx.slice_counts, ctx.adaptive
    bound = roofline.adaptive_bound_s(ctx.tests_per_segment, c["segs"], c["launches"],
                                      a.windows, a.n_sel, a.block_pixels, ctx.table_bytes,
                                      ctx.device_name)
    if bound is None:
        return None
    return 100.0 * bound / ctx.slice.trace_kernel_s
