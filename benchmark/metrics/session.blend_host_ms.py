"""Host time of the session's blend chain (the program's
``session.blend`` span around ``_blend_chain`` in
``RenderSession.step``): the median of its last calls outside the
profiled slice, in ms."""

from benchmark import program_spans


def read(ctx):
    return program_spans.median_ms("session.blend")
