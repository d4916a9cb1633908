"""Set-up's seconds inside the program: the totals of its set-up spans,
``session.init`` (``RenderSession.__init__``: the scene's compile, the
renderer), ``trace.tables`` (the gate tables' build) and ``kernel.load``
(the kernel's library: built or cached, then loaded)."""

from benchmark import program_spans

SPANS = ("session.init", "trace.tables", "kernel.load")


def read(ctx):
    return program_spans.total_s(SPANS)
