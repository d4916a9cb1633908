"""The trace kernels' share of their roofline in the profiled slice: the
bound (``benchmark/roofline.py``: the gated sweep's tests a segment on the
reference's pixels, scaled to the slice's segments, and the tables and
images once a launch) over the trace kernels' device time, in %.

The mesh cell's own copy: its images spread 1.1-1.7% in rate from run
to run, more than ``msamples_per_s``'s bound holds, so it reports
``msamples_per_s.mesh5``, and the same reading moves that."""

from benchmark import roofline


def read(ctx):
    if ctx.slice is None or ctx.slice.trace_kernel_s <= 0 or ctx.tests_per_segment is None:
        return None
    c = ctx.slice_counts
    bound = roofline.bound_s(ctx.tests_per_segment, c["segs"], c["launches"], c["frames"],
                             ctx.table_bytes, ctx.width, ctx.height, ctx.device_name)
    if bound is None:
        return None
    return 100.0 * bound / ctx.slice.trace_kernel_s
