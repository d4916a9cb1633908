"""Host time of the trace kernel's launch (the program's ``trace.launch``
span in ``kernels/trace.py:trace_spheres``, from entry to the return of
the launch): the median of its last calls outside the profiled slice, in
ms."""

from benchmark import program_spans


def read(ctx):
    return program_spans.median_ms("trace.launch")
