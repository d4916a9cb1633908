"""The traced run's profiled slice: ``torch.profiler`` over pieces of a
steady part of the window, their traces written into the checkout, and
what the per-layer readers take from them.

Each piece starts and ends at whole steps, each boundary after a device
synchronisation, so that every kernel in it belongs to a step issued in
it. A piece is short (a quarter of a second), because the profiler drops
the card's records when many come at once (half a second of an orbit's
were lost in a one-second slice); a piece is kept only where its trace
holds every trace-kernel launch the program counted in it.
The benchmark's spans (``bench.<name>``) are recorded as profiler
annotations inside the slice, so the trace names what the host was doing
during each idle gap of the device: the span that overlaps it most, or
``host`` (the harness's own loop) where none does.
"""

from __future__ import annotations

import collections
import json
import pathlib
from typing import NamedTuple

import torch

# Where the pieces lie: from START_S into the window (0.3 of a shorter
# one), PIECE_S each, until MIN_S of them are kept.
START_S, PIECE_S, MIN_S = 8.0, 0.25, 1.0
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# The trace kernels of csrc/trace.cu, by a part of their names.
TRACE_KERNELS = ("trace_spheres_kernel", "trace_adaptive_kernel")
SLICE = "bench.slice"
TOP = 10


class Slice:
    """A ``torch.profiler`` session over part of the window."""

    def __init__(self, cuda: bool = True):
        self.cuda = cuda
        self._prof = None
        self._mark = None

    @property
    def active(self) -> bool:
        return self._prof is not None

    def _profile(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return torch.profiler.profile(activities=acts)

    def warm(self) -> None:
        """Start and stop the profiler once, in set-up: its first start
        takes seconds, which the window must not pay."""
        with self._profile():
            torch.ones(1)

    def start(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()
        self._prof = self._profile()
        self._prof.__enter__()
        self._mark = torch.profiler.record_function(SLICE)
        self._mark.__enter__()

    def stop(self, path: pathlib.Path) -> DeviceSlice:
        """Stop, write the trace to ``path`` and read it."""
        if self.cuda:
            torch.cuda.synchronize()
        self._mark.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        path.parent.mkdir(parents=True, exist_ok=True)
        self._prof.export_chrome_trace(str(path))
        self._prof = self._mark = None
        return read_trace_file(path)


class DeviceSlice(NamedTuple):
    """What the device did in the slice, in seconds."""

    window_s: float
    busy_s: float
    trace_kernel_s: float  # the trace kernels
    other_kernel_s: float  # every other kernel
    copy_s: float  # copies and fills
    trace_events: int  # trace kernel launches that the trace holds
    device_ops: list  # [[name, seconds]] the longest in total, at most TOP
    idle_gaps: list  # [[host span, seconds]] the longest gaps, at most TOP


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def read_trace(events: list) -> DeviceSlice:
    """The slice's device busy time, kernel times by kind, the longest
    device operations and the longest idle gaps, from a chrome trace's
    events (times in microseconds)."""
    marks = [e for e in events if e.get("ph") == "X" and e.get("name") == SLICE
             and e.get("cat") == "user_annotation"]
    if not marks:
        raise ValueError("the trace has no slice annotation")
    t0 = float(marks[0]["ts"])
    t1 = t0 + float(marks[0]["dur"])
    spans, dev = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        a = float(e["ts"])
        b = a + float(e.get("dur", 0.0))
        if e.get("cat") == "user_annotation" and e["name"].startswith("bench.") \
                and e["name"] != SLICE:
            spans.append((a, b, e["name"][len("bench."):]))
        elif e.get("cat") in DEVICE_CATS:
            a, b = max(a, t0), min(b, t1)
            if b > a:
                dev.append((a, b, e["name"], e["cat"]))
    by_name = collections.Counter()
    trace_s = other_s = copy_s = 0.0
    trace_events = 0
    for a, b, name, cat in dev:
        d = (b - a) * 1e-6
        by_name[name] += d
        if cat != "kernel":
            copy_s += d
        elif any(k in name for k in TRACE_KERNELS):
            trace_s += d
            trace_events += 1
        else:
            other_s += d
    busy = _union([(a, b) for a, b, _, _ in dev])
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]

    def host_span(a, b):
        """The span that overlaps the gap ``[a, b)`` the most."""
        best, name = 0.0, "host"
        for s0, s1, n in spans:
            overlap = min(b, s1) - max(a, s0)
            if overlap > best:
                best, name = overlap, n
        return name

    gaps.sort(key=lambda g: g[0] - g[1])
    return DeviceSlice(
        window_s=(t1 - t0) * 1e-6,
        busy_s=sum(b - a for a, b in busy) * 1e-6,
        trace_kernel_s=trace_s, other_kernel_s=other_s, copy_s=copy_s,
        trace_events=trace_events,
        device_ops=[[n, s] for n, s in by_name.most_common(TOP)],
        idle_gaps=[[host_span(a, b), (b - a) * 1e-6] for a, b in gaps[:TOP]],
    )


def read_trace_file(path: pathlib.Path) -> DeviceSlice:
    with open(path) as f:
        return read_trace(json.load(f)["traceEvents"])


def merge(pieces: list) -> DeviceSlice:
    """The pieces of a slice as one: times summed, the longest operations
    and gaps over all of them."""
    ops = collections.Counter()
    for p in pieces:
        for name, sec in p.device_ops:
            ops[name] += sec
    gaps = sorted((g for p in pieces for g in p.idle_gaps), key=lambda g: -g[1])
    return DeviceSlice(
        *(sum(getattr(p, f) for p in pieces) for f in DeviceSlice._fields[:6]),
        device_ops=[[n, sec] for n, sec in ops.most_common(TOP)],
        idle_gaps=gaps[:TOP],
    )
