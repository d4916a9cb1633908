"""Launches of the trace kernel (``kernels/trace.py``'s ``KERNEL.launches``
counter) over the frames stepped in the window.

The mesh cell's own copy: its images spread 1.1-1.7% in rate from run
to run, more than ``msamples_per_s``'s bound holds, so it reports
``msamples_per_s.mesh5``, and the same reading moves that."""


def read(ctx):
    if not ctx.window.launches or not ctx.window.frames:
        return None
    return ctx.window.launches / ctx.window.frames
