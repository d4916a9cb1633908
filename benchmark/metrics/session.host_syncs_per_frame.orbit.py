"""Calls that block the host on the card (the program's host-sync sites,
``utils/profiling.host_sync``) over the frames stepped in the window;
set-up's few are counted too.

The orbit's own copy: that cell reports ``frame_ms_p95`` and not
``msamples_per_s``, so the same reading moves its tail."""

from benchmark import program_spans


def read(ctx):
    return program_spans.syncs_per_frame(ctx)
