"""What the per-layer readers take from the program's own spans and
host-sync counters: ``span_stats()`` of ``myraytracer_tpu_torch.utils.
profiling``, as the process that ran the cell holds it after the window.

The module is read where the program loaded it, and is not imported
here: only ``run.py`` loads the program. A program without
``span_stats`` (one older than its spans), or one that recorded nothing
under a name, gives None.

The aggregates cover the process's whole life: set-up's few calls and
syncs are in them, and the spans made while the profiler recorded are
not (they are annotations in the traced pieces instead)."""

import sys

PROGRAM_PROFILING = "myraytracer_tpu_torch.utils.profiling"


def stats():
    """The program's ``span_stats()``, or None."""
    read = getattr(sys.modules.get(PROGRAM_PROFILING), "span_stats", None)
    return read() if read is not None else None


def median_ms(name: str):
    """The median of the span ``name``'s last durations, in ms."""
    s = stats()
    if s is None or name not in s["spans"]:
        return None
    return s["spans"][name]["median_s"] * 1e3


def total_s(names) -> float:
    """The spans' totals summed, in s; None where none was recorded."""
    s = stats()
    found = [s["spans"][n]["total_s"] for n in names if s is not None and n in s["spans"]]
    return sum(found) if found else None


def syncs_per_frame(ctx):
    """Host syncs counted at every site over the window's frames."""
    s = stats()
    if s is None or not s["syncs"] or not ctx.window.frames:
        return None
    return sum(s["syncs"].values()) / ctx.window.frames
