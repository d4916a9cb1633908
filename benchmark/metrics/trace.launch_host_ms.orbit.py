"""Host time of the trace kernel's launch (the program's ``trace.launch``
span in ``kernels/trace.py:trace_spheres``): the median of its last calls
outside the profiled slice, in ms.

The orbit's own copy: that cell reports ``frame_ms_p95`` and not
``msamples_per_s``, so the same reading moves its tail."""

from benchmark import program_spans


def read(ctx):
    return program_spans.median_ms("trace.launch")
