"""Arithmetic of the end-to-end metrics, on host-clock readings."""

from __future__ import annotations

import math


def rate(count: float, seconds: float) -> float:
    """All the work of the window over all its time."""
    return count / seconds


def percentile(values, q: float) -> float:
    """The ``q``-th percentile of all ``values``, linearly interpolated
    between the order statistics (numpy's default rule)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def mean(values):
    values = list(values)
    return sum(values) / len(values) if values else None
