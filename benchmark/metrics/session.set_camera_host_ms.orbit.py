"""Host time of a camera move (the program's ``session.set_camera`` span
around ``RenderSession.set_camera``: the camera's packing and upload,
and the framebuffer's reset): the median of its last calls outside the
profiled slice, in ms."""

from benchmark import program_spans


def read(ctx):
    return program_spans.median_ms("session.set_camera")
