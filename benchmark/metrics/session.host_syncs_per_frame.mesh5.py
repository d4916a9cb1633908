"""Calls that block the host on the card (the program's host-sync sites,
``utils/profiling.host_sync``: the camera's upload, the segment read,
the gather, the NaN check, ``run``'s sync) over the frames stepped in the
window; set-up's few are counted too.

The mesh cell's own copy: its images spread 1.1-1.7% in rate from run
to run, more than ``msamples_per_s``'s bound holds, so it reports
``msamples_per_s.mesh5``, and the same reading moves that."""

from benchmark import program_spans


def read(ctx):
    return program_spans.syncs_per_frame(ctx)
