"""The 95th percentile, over every frame of the window, of the time from
the camera move (``set_camera``) to that frame's framebuffer in host
memory, in ms. Only traffic that moves the camera every step has it."""

from benchmark.stats import percentile


def read(ctx):
    if not ctx.window.latencies:
        return None
    return percentile(ctx.window.latencies, 95.0) * 1e3
