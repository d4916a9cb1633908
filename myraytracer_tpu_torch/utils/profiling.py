"""Profiling and debugging: the port of ``myraytracer_tpu.utils.profiling``.

* ``profile_trace``: a context manager around ``torch.profiler`` that
  records CPU and, on the card, CUDA activity (kernel launches and their
  device time) and writes a Chrome trace into a directory;
* ``enable_debug_nans``: the counterpart of ``jax_debug_nans``. A hand
  kernel cannot trip in the middle of a launch, so the sessions check what
  a step produced: with the switch on, each step's new framebuffer must be
  finite or the step raises ``FloatingPointError`` naming the frame, before
  the state takes it. With it off the check costs nothing: no sync and no
  extra launch.
"""

from __future__ import annotations

import contextlib
import logging
import pathlib

import torch

log = logging.getLogger("myraytracer_tpu_torch.profiling")

_DEBUG_NANS = False

TRACE_NAME = "trace.json"


@contextlib.contextmanager
def profile_trace(logdir):
    """Record a ``torch.profiler`` trace of the enclosed code into
    ``logdir/trace.json`` (Chrome trace format). Warns rather than fails
    when the profiler cannot start or stop."""
    out = pathlib.Path(logdir)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = None
    try:
        out.mkdir(parents=True, exist_ok=True)
        prof = torch.profiler.profile(activities=activities)
        prof.__enter__()
        log.info("profiler trace started → %s", out)
    except Exception as e:  # backend-dependent
        prof = None
        log.warning("profiler unavailable: %s", e)
    try:
        yield
    finally:
        if prof is not None:
            try:
                prof.__exit__(None, None, None)
                prof.export_chrome_trace(str(out / TRACE_NAME))
                log.info("profiler trace written to %s", out / TRACE_NAME)
            except Exception as e:
                log.warning("profiler stop failed: %s", e)


def enable_debug_nans(enable: bool = True) -> None:
    """Make every session step check its new framebuffer for NaN and inf."""
    global _DEBUG_NANS
    _DEBUG_NANS = bool(enable)


def debug_nans() -> bool:
    return _DEBUG_NANS


def check_finite(framebuffer: torch.Tensor, what: str) -> None:
    """Raise ``FloatingPointError`` naming ``what`` when the framebuffer
    holds a NaN or an inf (a sync on the card)."""
    if not bool(torch.isfinite(framebuffer).all()):
        raise FloatingPointError(f"debug-nans: {what} holds a NaN or an inf")
