"""Launches of the trace kernel (``kernels/trace.py``'s ``KERNEL.launches``
counter) over the frames stepped in the window."""


def read(ctx):
    if not ctx.window.launches or not ctx.window.frames:
        return None
    return ctx.window.launches / ctx.window.frames
