"""Profiling and debugging: the port of ``myraytracer_tpu.utils.profiling``.

* ``profile_trace``: a context manager around ``torch.profiler`` that
  records CPU and, on the card, CUDA activity (kernel launches and their
  device time) and writes a Chrome trace into a directory. The trace
  carries the program's spans (below) as annotations beside the card's
  kernels and copies;
* ``enable_debug_nans``: the counterpart of ``jax_debug_nans``. A hand
  kernel cannot trip in the middle of a launch, so the sessions check what
  a step produced: with the switch on, each step's new framebuffer must be
  finite or the step raises ``FloatingPointError`` naming the frame, before
  the state takes it. With it off the check costs nothing: no sync and no
  extra launch;
* ``span(name)`` and ``host_sync(site)``: the program's own spans on the
  host clock, and a count of each call that blocks the host on the card.

The spans, by name, and where they are recorded:

=========================  ===============================================
``session.init``           ``RenderSession.__init__`` (set-up)
``session.set_camera``     ``RenderSession.set_camera``
``session.step``           ``RenderSession.step``: the parent of the next two
``trace.launch``           ``kernels/trace.py:trace_spheres`` on the card, from
                           entry to the return of the kernel's launch
``session.blend``          the ``_blend_chain`` call in ``step``
``trace.tables``           a renderer's ``gate_tables`` build (set-up)
``kernel.load``            ``Kernel.load``'s first call: build or cached
                           library, then ``dlopen`` (set-up)
=========================  ===============================================

and the host-sync sites, each also a span of its name (not annotated):
``session.camera_upload`` (``set_camera``'s pageable copy of the packed
camera), ``session.segments`` (``segments_traced`` reading pending
totals), ``session.fetch_gather`` (``fetch_framebuffer``'s gather across
processes), ``session.nan_check`` (``check_finite``) and ``session.run``
(``RenderSession.run``'s closing synchronisation). A site counts each such
call on every device, the CPU included, so that a CPU run counts what a
card would wait on.

A span times its region with ``perf_counter_ns`` and keeps a per-thread
stack, so that a span's self time is its duration less its children's.
Only while a ``torch.profiler`` records does it also enter
``record_function``'s annotation (its C++ form,
``torch._C._profiler._RecordFunctionFast``): the span then lands in the
profiler's trace as a ``user_annotation``, on its clock, and is left out
of the aggregates. A host-sync site is then left out of the trace too:
only the spans a metric reads, and their parent ``session.step``, are
annotated, for each annotation in a frame widens the card's idle gaps in
a profiled slice. With no profiler a span enters no annotation, which
costs several times the aggregate. Each
name's aggregates take fixed memory however long the process runs: the
count, the total, the self time, its parents' names and a ring of the last
``RING`` durations. ``span_stats()`` returns them, with the sync counts,
as plain Python numbers::

    {"spans": {name: {"count", "total_s", "self_s", "median_s",
                      "parents": {parent name or None: count}}},
     "syncs": {site: count}}

Sync counts are kept while a profiler records too: a count is not a
time. ``reset_spans()`` empties both.
"""

from __future__ import annotations

import collections
import contextlib
import logging
import pathlib
import statistics
import threading
import time

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
    with host_sync("session.nan_check"):
        finite = bool(torch.isfinite(framebuffer).all())
    if not finite:
        raise FloatingPointError(f"debug-nans: {what} holds a NaN or an inf")


# -- spans and host syncs -------------------------------------------------------

RING = 4096  # durations kept a span name, for its median


class _Aggregate:
    """One span name's count, total and self time (ns), its parents' names
    with their counts, and its last ``RING`` durations (ns)."""

    __slots__ = ("count", "total_ns", "self_ns", "parents", "ring")

    def __init__(self):
        self.count = self.total_ns = self.self_ns = 0
        self.parents = {}
        self.ring = collections.deque(maxlen=RING)


_LOCK = threading.Lock()
_SPANS = {}  # name -> _Aggregate
_SYNCS = {}  # site -> calls
_LOCAL = threading.local()  # .stack: the thread's open spans
_profiler_enabled = torch._C._autograd._profiler_enabled
# ``record_function``'s annotation from C++, without its dispatcher ops.
_annotation = torch._C._profiler._RecordFunctionFast
_clock = time.perf_counter_ns


class _Span:
    __slots__ = ("name", "stack", "parent", "child_ns", "mark", "t0")
    annotated = True

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = self.stack = getattr(_LOCAL, "stack", None)
        if stack is None:
            stack = self.stack = _LOCAL.stack = []
        self.parent = stack[-1] if stack else None
        self.child_ns = 0
        self.mark = None
        if _profiler_enabled():
            self.mark = _annotation(self.name) if self.annotated else contextlib.nullcontext()
            self.mark.__enter__()
        stack.append(self)
        self.t0 = _clock()
        return self

    def __exit__(self, *exc):
        dur = _clock() - self.t0
        self.stack.pop()
        parent = self.parent
        if parent is not None:
            parent.child_ns += dur
        if self.mark is not None:
            self.mark.__exit__(*exc)
            return
        key = None if parent is None else parent.name
        with _LOCK:
            agg = _SPANS.get(self.name)
            if agg is None:
                agg = _SPANS[self.name] = _Aggregate()
            agg.count += 1
            agg.total_ns += dur
            agg.self_ns += dur - self.child_ns
            agg.parents[key] = agg.parents.get(key, 0) + 1
            agg.ring.append(dur)


def span(name: str) -> _Span:
    """A context manager that times the enclosed code as the span ``name``
    (see the module's docstring)."""
    return _Span(name)


class _Sync(_Span):
    __slots__ = ()
    annotated = False


def host_sync(site: str) -> _Span:
    """``span(site)`` around a program call that blocks the host on the
    card, counted under ``site``; not annotated in a profiler's trace."""
    with _LOCK:
        _SYNCS[site] = _SYNCS.get(site, 0) + 1
    return _Sync(site)


def span_stats() -> dict:
    """The spans' aggregates and the host-sync counts, as plain Python
    numbers (times in seconds; the module's docstring gives the layout)."""
    with _LOCK:
        spans = {name: {"count": a.count, "total_s": a.total_ns * 1e-9,
                        "self_s": a.self_ns * 1e-9,
                        "median_s": statistics.median(a.ring) * 1e-9,
                        "parents": dict(a.parents)}
                 for name, a in _SPANS.items()}
        return {"spans": spans, "syncs": dict(_SYNCS)}


def reset_spans() -> None:
    """Forget every span's aggregates and every sync count."""
    with _LOCK:
        _SPANS.clear()
        _SYNCS.clear()
