"""Host time of the trace kernel's launch (the program's ``trace.launch``
span in ``kernels/trace.py:trace_spheres``, from entry to the return of
the launch): the median of its last calls outside the profiled slice, in
ms.

The mesh cell's own copy: its images spread 1.1-1.7% in rate from run
to run, more than ``msamples_per_s``'s bound holds, so it reports
``msamples_per_s.mesh5``, and the same reading moves that."""

from benchmark import program_spans


def read(ctx):
    return program_spans.median_ms("trace.launch")
