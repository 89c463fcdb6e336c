"""Percentiles over all turns and rates over the whole window."""

from __future__ import annotations

import math


def percentile(values, q: float) -> float | None:
    """The *q*-th percentile (0-100) of every value, interpolated linearly
    between the order statistics; None for no values."""
    vals = sorted(values)
    if not vals:
        return None
    pos = (len(vals) - 1) * q / 100.0
    lo, hi = math.floor(pos), math.ceil(pos)
    return vals[lo] + (vals[hi] - vals[lo]) * (pos - lo)


def median(values) -> float | None:
    return percentile(values, 50.0)


def rate(events, t0: float, t1: float) -> float:
    """The sum of the amounts of (time, amount) *events* inside [t0, t1),
    over the window's seconds."""
    return sum(n for t, n in events if t0 <= t < t1) / (t1 - t0)
